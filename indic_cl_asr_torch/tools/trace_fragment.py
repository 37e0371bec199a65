"""Cut a small fragment of a ``scripts/profile_step.py`` trace: one device
event per kernel name, the host operations that launched them, and the
kernel work the capture reported (its ``capture.json``). The CPU tests
hold the step breakdown's categoriser and summary to a fragment of a card
trace (``tests/data/torch_step_trace_fragment.json``).

    python -m indic_cl_asr_torch.tools.trace_fragment LOGDIR OUT.json
"""

from __future__ import annotations

import argparse
import json
import os

from ..scripts.profile_step import DEVICE_CATS, _capture_info, _traces


def fragment(logdir: str) -> dict:
    with open(_traces(logdir)[-1]) as f:
        events = json.load(f)["traceEvents"]
    seen, kernels = set(), []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and e["name"] not in seen:
            seen.add(e["name"])
            kernels.append(e)
    ids = {e.get("args", {}).get("External id") for e in kernels}
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and e.get("args", {}).get("External id") in ids]
    slim = lambda e: {k: v if k != "args" else {"External id": v.get("External id")}  # noqa: E731
                      for k, v in e.items()}
    info = _capture_info(logdir)
    return {"source": "one event per kernel name of a torch.profiler trace of "
                      f"{info['steps']} flagship training steps (scripts/profile_step.py) on "
                      f"an {info['device']}, with the host ops that launched them; work: the "
                      "step's kernel work (capture.json)",
            "work": info["work"], "traceEvents": [slim(e) for e in kernels + ops]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logdir")
    ap.add_argument("out")
    args = ap.parse_args(argv)
    with open(args.out, "w") as f:
        json.dump(fragment(args.logdir), f, separators=(",", ":"))
    print(f"{args.out}: {os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
