"""Reduction of a ``torch.profiler`` trace of the traced window to what
the per-layer readers and the breakdown read: device time and launches by
kernel name, the device's busy time (the union of its operations), and its
idle gaps labelled by what the host was doing in them."""

from __future__ import annotations

import collections

import numpy as np
from torch.autograd import DeviceType

from .work import category, is_kernel

SPAN = "cl_bench."


def reduce_events(events, window_s: float) -> dict:
    dev, host = [], []
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        # record_function ranges are mirrored on the device's timeline as
        # user annotations: they are no device operations
        note = getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN)
        if e.device_type == DeviceType.CUDA and not note:
            dev.append((start, end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((start, end, e.name))
    kernels: dict[str, list] = {}
    for s, t, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) * 1e-6
        k[1] += 1
    # busy time: the union of the device's intervals (us)
    dev.sort()
    merged = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    by_cat = collections.Counter()
    for name, (sec, _) in kernels.items():
        by_cat[category(name)] += sec
    return {
        "busy_s": busy,
        "window_s": window_s,
        "kernels": kernels,
        "launches": sum(n for name, (_, n) in kernels.items() if is_kernel(name)),
        "device_ops": [[c, s] for c, s in by_cat.most_common(10)],
        "idle_gaps": idle_gaps(merged, host),
    }


def idle_gaps(merged, host, top: int = 400) -> list:
    """The longest gaps between device operations, summed by the host's
    activity at their midpoint: the innermost harness span and the
    outermost other host operation running then."""
    gaps = [(merged[i + 1][0] - merged[i][1], (merged[i][1] + merged[i + 1][0]) / 2)
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    gaps = gaps[:top]
    if not host or not gaps:
        return []
    starts = np.array([h[0] for h in host])
    ends = np.array([h[1] for h in host])
    names = [h[2] for h in host]
    is_span = np.array([n.startswith(SPAN) for n in names])
    total = collections.Counter()
    for length, mid in gaps:
        on = (starts <= mid) & (ends >= mid)
        label = []
        spans = np.nonzero(on & is_span)[0]
        if len(spans):  # innermost: the latest to start
            label.append(names[spans[np.argmax(starts[spans])]])
        ops = np.nonzero(on & ~is_span)[0]
        if len(ops):  # outermost: the earliest to start
            label.append(names[ops[np.argmin(starts[ops])]])
        total["_/_".join(label) or "host"] += length * 1e-6
    return [[k, v] for k, v in total.most_common(10)]
