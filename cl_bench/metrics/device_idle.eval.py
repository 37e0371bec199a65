"""Share (%) of the traced WER pass with no operation on the card."""


def read(rec):
    if rec["kind"] != "eval" or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
