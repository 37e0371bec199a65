"""Per-layer metrics: ``metrics/<name>.py`` reads one metric from the
traced run's record (cl_bench/run.py:traced_record). ``read(rec)`` returns
the number, or None where the record has nothing for it: the harness then
leaves the metric out of the result line."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cl_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_seconds(rec: dict, patterns) -> float:
    """Device time of the kernels whose names hold one of ``patterns``."""
    return sum(sec for name, (sec, _) in rec["kernels"].items()
               if any(p in name for p in patterns))
