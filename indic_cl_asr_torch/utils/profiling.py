"""Tracing and profiling of the port (PyTorch port of
indic_cl_asr_tpu/utils/profiling.py).

  * ``trace(log_dir, device)``: ``torch.profiler`` over the block (CPU
    activity, and CUDA activity on a card); on exit a Chrome trace JSON in
    ``log_dir`` (view in Perfetto or chrome://tracing);
  * ``span(name, args)``: a named span of the port's own (``asr.*``) in the
    trace (``record_function``) and in ``SPANS``, only while a
    ``torch.profiler`` session runs; otherwise a shared no-op;
  * ``StepTimer``: wall-clock step timing with a device sync, warmup
    discard and percentile stats;
  * ``device_memory_stats(device)`` / ``log_live_buffers(top_k)``: the
    allocator's statistics and the largest live tensors (a gc census);
  * ``device_profile(fn, top)``: one profiled call of ``fn``: device-busy
    ms, device operations, the kernels and host operations that take most;
  * ``KernelWork`` / ``FlopAudit``: the analytic work (bytes, FLOPs) of the
    port's kernel launches, the same functions as their bounds, which each
    wrapper reports through ``record_work``; a ``FlopAudit`` adds
    ``torch.utils.flop_counter.FlopCounterMode`` for everything else and
    hides the kernels' plain versions (and cuDNN's LSTM) from it
    (``counted_call``), so a program counts the same FLOPs on the CPU as on
    the card.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import os
import threading
import time
import warnings

import numpy as np
import torch
import torch.autograd.profiler as autograd_profiler
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from ..device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block; on exit write ``trace-<pid>-<ns>.json`` (Chrome
    trace format) into ``log_dir``. Yields the profiler. ``device`` is
    resolved as every entry point's (``None``: the card)."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class SpanTotals:
    """What the port's spans recorded while a profiler ran, per span name:
    how often it was entered, its host seconds (each span from its entry
    to its exit, on the thread that opened it, its children included), and
    how often each ``args`` string (a batch's shape) came. Spans on every
    thread add to it, the data producer's included."""

    def __init__(self):
        self._lock = threading.Lock()
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self._count: collections.Counter = collections.Counter()
            self._seconds: collections.Counter = collections.Counter()
            self._args: dict[str, collections.Counter] = {}

    def add(self, name: str, seconds: float, args: str | None) -> None:
        with self._lock:
            self._count[name] += 1
            self._seconds[name] += seconds
            if args:
                self._args.setdefault(name, collections.Counter())[args] += 1

    def as_dict(self) -> dict:
        """{name: {"count", "seconds", "args": {args: count}}}."""
        with self._lock:
            return {name: {"count": n, "seconds": self._seconds[name],
                           "args": dict(self._args.get(name, {}))}
                    for name, n in self._count.items()}


# every span entered under a profiler since the process started or since
# SPANS.clear(), which nothing in the package calls: a process that profiles
# two windows holds their sum
SPANS = SpanTotals()

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _span(name: str, args: str | None):
    with record_function(name, args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            SPANS.add(name, time.perf_counter() - t0, args)


def span(name: str, args=None):
    """A named span of the port (``asr.<layer>``) around the block, only
    while a ``torch.profiler`` session runs: a ``record_function`` in the
    trace, on the profiler's clock beside the kernels (nesting gives it
    its parent), and an entry in ``SPANS``. ``args`` is a string, or a
    callable returning one (the batch's shape, ``"B=16 S=64000 U=64"``),
    called only then. With no profiler running it is one shared
    ``nullcontext``: no string built, no ``RecordFunction`` created."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _span(name, args() if callable(args) else args)


def _sync(result) -> None:
    """Wait for the card that holds the first CUDA tensor in ``result`` (a
    tensor or a list, tuple or dict of them); nothing for CPU results."""
    todo = [result]
    while todo:
        x = todo.pop(0)
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)


class StepTimer:
    """Wall-clock step timing with device sync."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self, result_to_sync=None):
        """Time the block; at its end wait for the card that holds
        ``result_to_sync`` (a tensor, or a list, tuple or dict of them)."""
        t0 = time.perf_counter()
        yield
        _sync(result_to_sync)
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    def time_fn(self, fn, *args, iters: int = 10, **kw):
        """Time fn(*args), waiting for its result after every call; returns
        {"mean_s", "iters"}. The first call (a kernel build, an allocator's
        first blocks) and ``warmup`` more are not timed."""
        out = fn(*args, **kw)
        _sync(out)
        for _ in range(self.warmup):
            out = fn(*args, **kw)
        _sync(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kw)
            _sync(out)
        per = (time.perf_counter() - t0) / iters
        self.times.append(per)
        return {"mean_s": per, "iters": iters}

    def stats(self) -> dict:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p95_s": float(np.percentile(a, 95)),
            "steps": len(a),
        }


def device_memory_stats(device="cuda") -> dict:
    """The caching allocator's statistics for a card (bytes and counts,
    ``torch.cuda.memory_stats``); an empty dict for the CPU, which keeps
    none, as the JAX function gives for a backend without them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(dev))


def log_live_buffers(top_k: int = 20, device="cuda") -> list[tuple[tuple, str, int]]:
    """The largest live tensors on ``device``'s kind of memory as
    [(shape, dtype, nbytes)], found by a gc census (the analogue of the
    JAX package's ``jax.live_arrays``)."""
    kind = torch.device(device).type
    infos = []
    with warnings.catch_warnings():  # deprecated objects warn when their class is read
        warnings.simplefilter("ignore", FutureWarning)
        tensors = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
    for obj in tensors:
        if obj.device.type == kind:
            infos.append((tuple(obj.shape), str(obj.dtype), obj.numel() * obj.element_size()))
    infos.sort(key=lambda x: -x[2])
    return infos[:top_k]


def device_profile(fn, top: int = 12, host: bool = True) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CUDA activity, and CPU
    activity with ``host``), the card synchronised before and after:
    {"device_busy_ms": the kernels' and copies' device time on the card,
    "device_ops": their count, "kernels": every device name as {"name",
    "calls", "device_ms"} by time, "top": the first ``top`` of them,
    "top_host": the ``top`` host operations by self time, as {"name",
    "calls", "host_ms"} (inflated by the profiler)}."""
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    stats = prof.key_averages()
    dev = sorted((e for e in stats if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.self_device_time_total, reverse=True)
    kernels = [{"name": e.key, "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
               for e in dev]
    cpu = sorted((e for e in stats if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"device_busy_ms": sum(k["device_ms"] for k in kernels),
            "device_ops": sum(k["calls"] for k in kernels),
            "kernels": kernels, "top": kernels[:top],
            "top_host": [{"name": e.key, "calls": e.count, "host_ms": e.self_cpu_time_total / 1e3}
                         for e in cpu[:top]] if host else []}


# the work logs being kept (KernelWork blocks entered, innermost last)
_LOGS: list = []


class KernelWork:
    """The analytic work of the port's kernel launches while the block
    runs: per wrapper name its calls, bytes and FLOPs, each launch counted
    by the function that gives its bound (``ops/flash_mhsa.py:work``,
    ``ops/rnnt_loss.py:work``, ...) through ``record_work``."""

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.flops: collections.Counter = collections.Counter()

    def __enter__(self):
        _LOGS.append(self)
        return self

    def __exit__(self, *exc):
        _LOGS.remove(self)

    def add(self, name: str, nbytes: int, flops: int) -> None:
        self.calls[name] += 1
        self.bytes[name] += int(nbytes)
        self.flops[name] += int(flops)

    def as_dict(self) -> dict:
        return {name: {"calls": self.calls[name], "bytes": self.bytes[name],
                       "flops": self.flops[name]} for name in sorted(self.calls)}


def record_work(name: str, work) -> None:
    """At a launch of the kernel wrapper ``name`` (or, inside a FLOP audit,
    a call of its plain version): ``work()`` -> (bytes, flops) added to
    every log being kept. Nothing is computed when none is."""
    if _LOGS:
        with _disable_current_modes():  # the shapes' arithmetic is no work of the program
            nbytes, flops = work()
        for log in _LOGS:
            log.add(name, nbytes, flops)


def auditing() -> bool:
    """Whether a ``FlopAudit`` is counting."""
    return any(isinstance(log, FlopAudit) for log in _LOGS)


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    """``aten.convolution_backward``: the input's and the weight's gradients
    each take the forward's products. torch's own formula counts a grouped
    convolution's weight gradient as if it were dense (a depthwise conv's
    backward at d channels as d+1 forwards), so the audit uses this one."""
    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


class FlopAudit(KernelWork):
    """FLOPs of the programs run in the block: ``FlopCounterMode`` for the
    operators PyTorch dispatches (GEMMs, convolutions and their backward,
    the latter by ``conv_backward_flops``; it counts no elementwise work),
    plus each port kernel's analytic FLOPs (``KernelWork``). The card's
    kernels are invisible to the counter; on the CPU their plain versions
    run through ``counted_call``, which hides them from it, so both count
    the same."""

    def __init__(self):
        super().__init__()
        self.counter = FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: conv_backward_flops})

    def __enter__(self):
        if auditing():
            raise RuntimeError("FLOP audits do not nest")
        super().__enter__()
        self.counter.__enter__()
        return self

    def __exit__(self, *exc):
        self.counter.__exit__(*exc)
        super().__exit__(*exc)

    def counted(self) -> int:
        """The counter's FLOPs: what is not a kernel of the port."""
        return int(self.counter.get_total_flops())

    def total(self) -> int:
        return self.counted() + sum(self.flops.values())


class _Hidden(torch.autograd.Function):
    """``fn(*inputs)`` hidden from the dispatch modes (the FLOP counter)
    in its forward and in its backward, which recomputes it and takes the
    gradients by autograd; each records its analytic work."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        fn, fwd, bwd = spec
        record_work(*fwd)
        with _disable_current_modes():
            out = fn(*inputs)
        ctx.spec = spec
        ctx.save_for_backward(*inputs)
        return out

    @staticmethod
    def backward(ctx, *douts):
        fn, _, bwd = ctx.spec
        if bwd is not None:
            record_work(*bwd)
        inputs = ctx.saved_tensors
        leaves = [x.detach().requires_grad_(x.requires_grad) for x in inputs]
        wanted = [x for x in leaves if x.requires_grad]
        with _disable_current_modes(), torch.enable_grad():
            out = fn(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, d) for o, d in zip(outs, douts) if o.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                             [d for _, d in pairs], allow_unused=True))
        return (None, *(next(grads) if x.requires_grad else None for x in leaves))


def counted_call(fn, inputs: tuple, fwd: tuple, bwd: tuple):
    """``fn(*inputs)``: a kernel's plain version, or a library call the
    counter does not see on the card (cuDNN's LSTM). Outside a FLOP audit a
    plain call. Inside one, its operators are hidden from the counter and
    ``fwd`` = (name, work) is recorded instead, and ``bwd`` (if not None)
    when autograd takes its backward (recomputing ``fn``)."""
    if not auditing():
        return fn(*inputs)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _Hidden.apply((fn, fwd, bwd), *inputs)
    record_work(*fwd)
    with _disable_current_modes():
        return fn(*inputs)
