"""The whole WER pass's share (%) of the card's bf16 peak: front end,
encoder, joint projection, CTC head and the RNNT emissions made, over the
traced window."""

from cl_bench.work import PEAK_FLOPS, eval_batch_flops


def read(rec):
    if rec["kind"] != "eval" or not rec["batches"] or rec["window_s"] <= 0:
        return None
    flops = sum(eval_batch_flops(rec["model"], rec["frontend"], b["B"], b["S"], b["lens"],
                                 b["decoder"], b["joint_evals"], b["lstm_steps"])
                for b in rec["batches"])
    return 100.0 * flops / (rec["window_s"] * PEAK_FLOPS)
