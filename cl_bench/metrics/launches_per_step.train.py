"""Kernel launches on the card per training step in the traced window."""


def read(rec):
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    return rec["launches"] / len(rec["steps"])
