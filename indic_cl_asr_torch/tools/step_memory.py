"""Peak device memory of one flagship CL training step, for any checkout.

    python3 indic_cl_asr_torch/tools/step_memory.py [ROOT]

Runs ``chip_smoke.py``'s phase-8 step set-up (the flagship model, bf16,
layers 0-11 frozen, seeded random weights; one B16 batch of 4.5-8 s
synthetic WAVs; one warm-up step under each ``rnnt_impl``) with the port
found under ROOT (default: this checkout), then one step each of
``"pallas"`` and ``"xla"`` with the peak of ``max_memory_allocated``
over it. The procedure is this checkout's ``chip_smoke.py``, so two
checkouts are measured the same way: run it once for each, one after
the other on one card. Prints one JSON line. Needs a CUDA card; exits 2
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
        print("step_memory: no CUDA device is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import indic_cl_asr_torch
    from indic_cl_asr_torch.data.pipeline import BucketSpec
    from indic_cl_asr_torch.ops import _build

    _build.build()
    dev = torch.device("cuda", 0)
    tasks, tok = cs.make_cl_data(os.path.join(root, "build", "step_memory", "wavs"))
    bucket = BucketSpec(boundaries_sec=(4.0, 8.0), max_tokens=(64, 128))
    _, _, train, host, batch, gen = cs.cl_step_setup(dev, tasks, tok, bucket)
    mem = cs.step_peak_bytes(train, batch, gen)
    print(json.dumps({"root": root, "package": os.path.dirname(indic_cl_asr_torch.__file__),
                      "card": cs.nvidia_smi(), "batch": list(host.tokens.shape),
                      "memory_bytes": mem}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
