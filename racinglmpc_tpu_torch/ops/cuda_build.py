"""Build and load the port's CUDA kernels (plain C interface over ctypes).

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper); the objects are linked into one
shared library under ``<repo>/build/kernels/``, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
the existing library. The build happens at the first kernel launch, never
at import. ``DEFINES`` (empty: the kernels as they run) adds ``-D`` macros
to the build the wrappers launch, e.g. ``QP_PHASES`` for the ADMM kernels'
phase clocks (``runtime/admm_bench.py --phases``).

Importing this module turns TF32 off for float32 matmuls and convolutions:
the ADMM and Newton-Schulz iterations run at cond(K) ~ 1e5-1e6, where
reduced-precision products stop them from converging.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("runtime.cu", "cuda_rollout.cu", "cuda_sysid.cu", "cuda_qp.cu",
           "cuda_qp_fused.cu")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFINES: tuple = ()

# one H100 SXM: SMs, shared memory of an SM and the most one CTA may take
# (bytes), the runtime's shared-memory reservation per CTA, registers of an
# SM
N_SM = 132
SMEM_PER_SM = 233_472
SMEM_PER_CTA = 232_448
SMEM_RESERVED = 1_024
REGS_PER_SM = 65_536


class LaunchCounter:
    """Launches of one kernel; its wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def reset(self) -> None:
        self.n = 0


class ScenarioCounter:
    """Scenarios a kernel marked (e.g. ran in its streaming layout), summed
    on the device: the kernel adds one per scenario with an integer atomic,
    so counting costs no host sync; :meth:`value` reads it (and syncs)."""

    def __init__(self, name: str):
        self.name = name
        self._t = {}

    def tensor(self, device) -> torch.Tensor:
        """The (1,) int32 counter on ``device`` the kernel adds to."""
        key = torch.device(device)
        if key not in self._t:
            self._t[key] = torch.zeros((1,), dtype=torch.int32, device=key)
        return self._t[key]

    def reset(self) -> None:
        for t in self._t.values():
            t.zero_()

    def value(self) -> int:
        return sum(int(t.item()) for t in self._t.values())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")
    return path


def _flags(defines) -> tuple:
    return FLAGS + tuple(f"-D{d}" for d in defines)


def _digest(defines) -> str:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


class Build:
    """The loaded library and what its build took (``seconds`` is 0 when a
    library built earlier from the same sources was loaded)."""

    def __init__(self, lib: ctypes.CDLL, path: pathlib.Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds
        self.log = log


def _compile(out: pathlib.Path, defines) -> str:
    nvcc = _nvcc()
    tmp = out.parent / f".tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = tmp / (src + ".o")
        cmd = [nvcc, *_flags(defines), "-I", str(CSRC), "-c",
               str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, _, p in procs:
        text, _ = p.communicate()
        log.append(f"== {src}\n{text}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log))
    so_tmp = tmp / out.name
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(so_tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(so_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(log)


@functools.lru_cache(maxsize=None)
def build(defines: tuple = ()) -> Build:
    """Compile (if needed) and load the kernel library with ``-D`` macros
    ``defines``; cached per process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libracinglmpc_kernels_{_digest(defines)}.so"
    t0 = time.time()
    log = ""
    if not out.exists():
        log = _compile(out, defines)
        (BUILD_DIR / "build.log").write_text(log)
    seconds = time.time() - t0 if log else 0.0
    lib = ctypes.CDLL(str(out))
    lib.rl_error_string.argtypes = [ctypes.c_int]
    lib.rl_error_string.restype = ctypes.c_char_p
    return Build(lib, out, seconds, log)


def library() -> ctypes.CDLL:
    return build(DEFINES).lib


def bind(lib: ctypes.CDLL, name: str, argtypes, restype=ctypes.c_int):
    """``lib.name`` with its prototype set (once per library: callers keep
    the result, e.g. behind ``functools.lru_cache``)."""
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(err: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        msg = library().rl_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")


def stream_ptr() -> ctypes.c_void_p:
    """The current CUDA stream of the current device (the raw handle, read
    without building a ``torch.cuda.Stream``: a few microseconds less per
    launch)."""
    return ctypes.c_void_p(
        torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def expect(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
