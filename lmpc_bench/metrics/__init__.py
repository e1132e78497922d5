"""One reader per per-layer metric, ``<metric name>.py``, each with
``read(rec) -> float | None`` over a traced run's record (see
``lmpc_bench/run.py``: ``record``). A reader that finds nothing to read
returns None, and the metric is left out of the run's line."""
