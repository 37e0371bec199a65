"""The eval cell's blank calibration pins the port's greedy RNNT decode to
the mix's emission rate on the batch it calibrates on."""

import pytest
import torch

from cl_bench import traffic
from cl_bench.calibrate import calibrate, frames_per_s
from cl_bench.cells import LANGUAGES, program_parts, tokenizer
from cl_bench.check import assemble
from cl_bench.reference.layout import make_weights
from cl_bench.run import load
from cl_bench.work import encoder_frames, mel_frames


@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 3])
def test_the_port_emits_the_target_rate_on_the_calibration_batch(tmp_path, seed):
    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC
    from indic_cl_asr_torch.train.eval import Transcriber

    cfg, mix = load("configs", "indicconformer_large"), load("traffic", "wer_eval")
    cfg["model"].update(n_layers=2, d_model=64, n_heads=4, ff_expansion_factor=2,
                        conv_kernel_size=7, pred_hidden=64, joint_hidden=64, dtype="float32")
    mix.update(batch_size=16, buckets=[[2.0, 4.0, 16]], bucket_boundaries_s=[4.0],
               bucket_max_tokens=[64], languages=["hindi"])
    utts = traffic.generate(mix, seed, str(tmp_path), torch.device("cpu"))
    first = [u for u in utts if u.set == "val_clean"]
    weights = make_weights(cfg["model"], seed, "cpu", serving=True)
    calibrate(cfg, mix, weights, {"hindi": first}, "cpu")
    hybrid, _, frontend = program_parts(cfg)
    model = HybridRNNTCTC(hybrid, device="cpu")
    model.load_state_dict(weights)
    tr = Transcriber(model=model, tokenizer=tokenizer(["hindi"]), languages=LANGUAGES,
                     frontend=frontend, batch_size=16)
    b = assemble(first, mix, "cpu")
    rows = tr.decode_batch(b["audio"], b["audio_len"], b["lang_ids"], "rnnt")
    frames = sum(encoder_frames(mel_frames(u.samples), cfg["model"]) for u in first)
    rate = sum(len(r) for r in rows) / frames
    target = mix["tokens_per_s"] / frames_per_s(cfg)
    assert abs(rate - target) < 0.1 * target
