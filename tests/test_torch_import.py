"""The port imports torch and numpy only: never jax, never racinglmpc_tpu."""
import os
import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "racinglmpc_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_leaves_jax_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in _modules())
            + "import runpy\n"
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
              "('jax.', 'jaxlib', 'racinglmpc_tpu.')) or m == 'racinglmpc_tpu']\n"
            + "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_slice_modules_are_covered():
    """The modules of the four-stage slice, of the mesh path and of the
    bench are among those imported above (and so checked for JAX)."""
    mods = set(_modules())
    for m in ("controllers.mpc", "ops.cuda_qp_fused", "ops.kkt_band",
              "runtime.checkpoint", "runtime.metrics", "runtime.presets",
              "runtime.experiment", "parallel.mesh", "ops.qp_sharded",
              "controllers.giant_ftocp", "viz.plots",
              "runtime.dump_scenario", "runtime.bench", "runtime.native",
              "runtime.rescue_replay"):
        assert f"racinglmpc_tpu_torch.{m}" in mods, m
    assert (PKG / "csrc" / "cuda_qp_fused.cu").exists()
    assert (PKG / "csrc" / "qp_common.cuh").exists()


def test_sources_do_not_name_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import racinglmpc_tpu\b|"
                     r"from racinglmpc_tpu[ .])", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        assert not pat.search(text), path
        assert not re.search(r"racinglmpc_tpu\.[a-z]", text), path
