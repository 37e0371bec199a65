"""RNNT tokens emitted per valid encoder frame in the traced WER pass,
counted from what the greedy decode returned: the control that the decode
did the work the cell states."""


def read(rec):
    if rec["kind"] != "eval":
        return None
    rnnt = [b for b in rec["batches"] if b["decoder"] == "rnnt"]
    frames = sum(sum(b["lens"]) for b in rnnt)
    if not frames:
        return None
    return sum(sum(b["emitted"]) for b in rnnt) / frames
