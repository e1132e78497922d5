"""The harness computes what it computed before the controller stages were
split out of it: ``lmpc_b256.converged_lap`` at batch 4 on the CPU, two
episodes on a fixed seed, held to the record
``data/frozen_lmpc_b256.json`` that ``data/frozen_record.py`` wrote on the
tree before the split (the kept state fields and plant draws, the samples
the judge was handed, the counters, the roofline counts and every compared
number but the plant's, exactly)."""
import importlib.util
import json
import pathlib

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _frozen_record():
    spec = importlib.util.spec_from_file_location(
        "lmpc_bench_frozen_record", DATA / "frozen_record.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_lmpc_cell_computes_what_it_did_before_the_stage_split():
    want = json.loads((DATA / "frozen_lmpc_b256.json").read_text())
    got = json.loads(json.dumps(_frozen_record().record(), sort_keys=True))
    assert got["calls"] == [90, 90]              # two whole laps
    for key in sorted(want):
        assert got[key] == want[key], key
    assert got == want
