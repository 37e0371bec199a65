"""Mean ms a training step waits for its next batch: the harness's span
around the fetch from the port's BatchPipeline (data/pipeline.py)."""


def read(rec):
    waits = rec.get("data_wait_s")
    if rec["kind"] != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
