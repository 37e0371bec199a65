"""Seconds of real (unpadded) audio trained per second of the traced
window (two epochs under the profiler, on the host's clock): the
training rate where it is too noisy to hold end to end."""


def read(rec):
    if rec["kind"] != "train" or not rec.get("audio_s") or rec["window_s"] <= 0:
        return None
    return rec["audio_s"] / rec["window_s"]
