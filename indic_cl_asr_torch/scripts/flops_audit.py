"""Audit the flagship step's FLOPs: what PyTorch counts, plus the port's
kernels counted analytically (the port's scripts/flops_audit.py).

The JAX script prints XLA's cost analysis of the programs bench.py times
beside bench.py's analytic 1.5 TFLOP a step. This one counts the same
three programs of the port's flagship step (``tools/flagship.py``: B16 x
8 s, U 48, layers 0-11 frozen, flash attention): the loss forward, the
forward and backward, and the full step (AdamW included), each in one
``utils/profiling.py:FlopAudit``:

  * ``torch.utils.flop_counter.FlopCounterMode`` counts the operators
    PyTorch dispatches: GEMMs and convolutions and their backward (no
    elementwise work, which XLA's count includes);
  * each port kernel (flash attention forward and backward, the alpha and
    beta lattices) is counted by the function of its bound
    (``ops/flash_mhsa.py:work``, ``work_backward``, ``ops/rnnt_loss.py:
    work``), once a launch on the card and once a call of its plain
    version on the CPU, whose operators are hidden from the counter;
  * the prediction net's ``torch.lstm`` (cuDNN's own kernels on the card,
    which the counter does not see) is counted the same way
    (``models/rnnt.py:lstm_work``; its backward twice its forward) and is
    reported among the kernels as ``lstm`` / ``lstm_backward``.

So the count is the same on ``--device cpu`` as on the card, to the FLOP:

    python -m indic_cl_asr_torch.scripts.flops_audit             # the card
    python -m indic_cl_asr_torch.scripts.flops_audit --device cpu

Prints one JSON line: {"loss_fwd_tflops", "fwd_bwd_tflops",
"full_step_tflops", "analytic_step_tflops", "device", "programs": {name:
{"flops", "counted_flops", "kernels": {name: {"calls", "bytes",
"flops"}}, "launches": {wrapper: launches on the card}}}}.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..models.common import Rngs
from ..ops import _build
from ..ops.flash_mhsa import flash_relpos_mhsa, flash_relpos_mhsa_backward
from ..ops.rnnt_loss import rnnt_alpha, rnnt_beta
from ..tools.flagship import ANALYTIC_STEP_TFLOPS, FlagshipStep, flagship_step
from ..train.step import hybrid_forward_loss
from ..utils.profiling import FlopAudit

# the kernel wrappers the audited programs launch
WRAPPERS = (flash_relpos_mhsa, flash_relpos_mhsa_backward, rnnt_alpha, rnnt_beta)


def audit(fs: FlagshipStep) -> dict:
    """{program: {"flops", "counted_flops", "kernels", "launches"}} for the
    loss forward, the forward and backward, and the full step of ``fs``."""
    model, batch = fs.model, fs.batch

    def loss_fwd():
        rngs = Rngs.from_host(torch.Generator().manual_seed(0), model.device)
        return hybrid_forward_loss(model, fs.step_cfg, batch, rngs, train=True)[0]

    def fwd_bwd():
        return torch.autograd.grad(loss_fwd(), fs.optimizer.params, allow_unused=True)

    def full_step():
        return fs.step(batch, torch.Generator().manual_seed(0))

    out = {}
    for name, fn in (("loss_fwd", loss_fwd), ("fwd_bwd", fwd_bwd), ("full_step", full_step)):
        before = {w.__name__: w.launches for w in WRAPPERS}
        with FlopAudit() as a:
            fn()
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        out[name] = {"flops": a.total(), "counted_flops": a.counted(),
                     "kernels": a.as_dict(),
                     "launches": {w.__name__: w.launches - before[w.__name__] for w in WRAPPERS}}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        _build.build()
    programs = audit(flagship_step(dev))
    tf = lambda n: round(programs[n]["flops"] / 1e12, 3)  # noqa: E731
    result = {"loss_fwd_tflops": tf("loss_fwd"), "fwd_bwd_tflops": tf("fwd_bwd"),
              "full_step_tflops": tf("full_step"), "analytic_step_tflops": ANALYTIC_STEP_TFLOPS,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "programs": programs}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
