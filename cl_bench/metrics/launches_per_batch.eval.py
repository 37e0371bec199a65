"""Kernel launches on the card per decoded batch in the traced WER pass."""


def read(rec):
    if rec["kind"] != "eval" or not rec["batches"]:
        return None
    return rec["launches"] / len(rec["batches"])
