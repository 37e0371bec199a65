"""Time the flash rel-pos attention on the card, for any checkout.

    python3 indic_cl_asr_torch/tools/profile_flash.py [ROOT]

Runs the forward of the port found under ROOT (default: this checkout) in
bf16 at H8 D64: on seeded random operands at the flagship case of
``chip_smoke.py``'s phase 3 (B16 T204, its ``FLASH_LENS``), without and
with dropout 0.1, and at layer 0's operands in the CL evaluation's batches
of each shape (B16 T104 and T204), made as phase 8 makes them
(``eval_flash_operands``: the same synthetic WAVs, Transcriber and seeded
flagship model). Each is timed three ways (``chip_smoke.py``'s
``flash_timings``): CUDA events over eager calls, CUDA events over a CUDA
graph of calls (no host time between launches), and the kernel's device
time from torch.profiler; with the max abs error against the plain
version (``chip_smoke.py`` gives the bounds). Then the backward at the
flagship case, without and with dropout 0.1, the row statistics from the
same checkout's forward and a seeded cotangent, the biases in f32 as the
training step passes them (its parameters), timed as
``chip_smoke.py``'s ``flash_bwd_timings`` times it (eager on those
operands, and on operands cast first eager, over a graph and on the
device), with each gradient's max error over max|ref| against the plain
version's autograd. The procedure is this
checkout's, so two checkouts are measured the same way: run it for each,
in turns, on one card. Prints one JSON line. Needs a CUDA card; exits 2
without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, root)  # the port under test, before anything imports it
    import torch

    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import indic_cl_asr_torch
    from indic_cl_asr_torch.data.pipeline import BucketSpec
    from indic_cl_asr_torch.ops import flash_mhsa as fm

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    tasks, tok = cs.make_cl_data(os.path.join(root, "build", "profile_flash", "wavs"))
    bucket = BucketSpec(boundaries_sec=(4.0, 8.0), max_tokens=(64, 128))
    cases = {}
    for name, rate in (("B16 T204", 0.0), ("B16 T204 dropout 0.1", 0.1)):
        args = cs.flash_inputs(16, 204, 8, 64, cs.FLASH_LENS, torch.bfloat16, dev, seed=220)
        cases[name] = (args, rate)
    for (B, T), args in sorted(cs.eval_flash_operands(dev, tasks, tok, bucket).items()):
        cases[f"eval B{B} T{T}"] = (args, 0.0)
    out = {"root": root, "package": os.path.dirname(indic_cl_asr_torch.__file__),
           "card": cs.nvidia_smi()}
    with torch.inference_mode():
        for name, (args, rate) in cases.items():
            q, lens = args[0], args[6]
            kw = dict(n_heads=8, dropout_rate=rate, seed=5)
            err = (fm.flash_relpos_mhsa(*args, **kw).float()
                   - fm.flash_relpos_mhsa_reference(*args, **kw).float()).abs().max().item()
            out[name] = {**cs.flash_timings(args, **kw), "max_abs_err": err,
                         "shape": list(q.shape), "lens": lens.tolist()}
    for name in ("B16 T204", "B16 T204 dropout 0.1"):
        args, rate = cases[name]
        kw = dict(n_heads=8, dropout_rate=rate, seed=5)
        q, lens = args[0], args[6]
        cast = (*args[:4], args[4].to(q.dtype), args[5].to(q.dtype), lens)
        with torch.no_grad():
            _, lse = fm._launch_fwd(*cast, 8, -1, -1, rate, 5, need_lse=True)
        dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(dev, q.dtype)
        step = (*args[:4], args[4].float(), args[5].float(), lens)  # the step's bias dtype
        got = fm.flash_relpos_mhsa_backward(*step, lse, dout, **kw)
        want = fm.flash_relpos_mhsa_backward_reference(*step, dout, **kw)
        errs = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                for a, b in zip(got, want)]
        out[f"backward {name}"] = {**cs.flash_bwd_timings((*step, lse, dout), **kw),
                                   "max_rel_err": max(errs), "shape": list(q.shape),
                                   "lens": lens.tolist()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
