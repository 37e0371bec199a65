"""The port's own spans (``utils/profiling.py:span``, names ``asr.*``) as
the per-layer readers take them: the totals the program keeps in
``SPANS`` for every span entered while a profiler ran. The module is
looked up among those the program loaded, not imported: a program that
keeps no such totals (one older than its spans) gives None, and so does
every reader.

Nothing clears the totals, so they are the traced window's only where
the process profiled one window, as ``run.py`` does (one cell a run).
That is checked, not assumed: the span that comes once a training step
(``asr.optimizer``) or once a decoded batch (``asr.eval.detokenize``)
must have come exactly as often as the record's steps or batches;
totals of two windows read None, never their sum. Span seconds are the
host's, from entry to exit: where the program waits for the card inside
a span (a blocking copy or a sync), the wait is in them."""

from __future__ import annotations

import re
import sys

PROGRAM = "indic_cl_asr_torch.utils.profiling"
# per kind of record: the span that comes once per unit, and the record's units
ONCE = {"train": ("asr.optimizer", "steps"), "eval": ("asr.eval.detokenize", "batches")}


def recorded(rec: dict, kind: str) -> dict | None:
    """{name: {"count", "seconds", "args": {args: count}}} of the program's
    spans in the traced window of ``rec``, a record of ``kind``; None for
    a record of the other kind, a program without span totals, or totals
    that are not this window's alone."""
    totals = getattr(sys.modules.get(PROGRAM), "SPANS", None)
    if rec["kind"] != kind or totals is None:
        return None
    spans = totals.as_dict()
    once, units = ONCE[kind]
    n = len(rec[units])
    return spans if n and count(spans, once) == n else None


def count(spans: dict, *names: str) -> int:
    return sum(spans[n]["count"] for n in names if n in spans)


def seconds(spans: dict, *names: str) -> float:
    return sum(spans[n]["seconds"] for n in names if n in spans)


def ms_per_unit(rec: dict, kind: str, *names: str) -> float | None:
    """Host ms in the spans ``names`` per step (``kind`` "train") or per
    decoded batch ("eval") of the record; None where they are missing."""
    spans = recorded(rec, kind)
    if not spans or not count(spans, *names):
        return None
    return 1e3 * seconds(spans, *names) / len(rec[ONCE[kind][1]])


def ms_each(rec: dict, kind: str, name: str) -> float | None:
    """Host ms of one ``name`` span, its mean over the window."""
    spans = recorded(rec, kind)
    if not spans or not count(spans, name):
        return None
    return 1e3 * seconds(spans, name) / count(spans, name)


def arg_sum(spans: dict, name: str, key: str) -> int:
    """The sum of the integer ``key=`` in the args of every ``name`` span."""
    total = 0
    for args, n in spans.get(name, {}).get("args", {}).items():
        m = re.search(rf"\b{key}=(\d+)", args)
        if m:
            total += n * int(m.group(1))
    return total
