"""The plain reference against the port at a tiny configuration on the
CPU, through a whole run of the harness (set-up, window, check), and the
check failing each fault the cells can have, planted under the timed path."""

import pytest
import torch

from cl_bench.run import run

TINY = {"model": dict(n_layers=2, d_model=64, n_heads=4, ff_expansion_factor=2,
                      conv_kernel_size=7, pred_hidden=32, joint_hidden=32, frozen_till=1,
                      dtype="float32"),
        "train": dict(freeze_encoder_till=1)}
MIX = dict(batch_size=4, buckets=[[0.5, 1.0, 4], [1.0, 2.0, 4], [2.0, 3.0, 4], [3.0, 4.0, 4]],
           bucket_boundaries_s=[1.0, 2.0, 3.0, 4.0], bucket_max_tokens=[16, 32, 48, 64])
TRAIN, EVAL = "indicconformer_large.cl_task", "indicconformer_large.wer_eval"


def tiny_run(workload, seed=3, **hooks):
    torch.manual_seed(0)
    return run(workload, seed, 0.5, False, torch.device("cpu"), overrides=TINY,
               mix_overrides=MIX, hooks=hooks)


def test_training_reference_follows_the_port_s_steps():
    res = tiny_run(TRAIN)
    c = res["checks"]
    assert c["loss_gap"]["value"] < 1e-5
    assert c["grad_gap"]["value"] < 1e-4
    assert c["update_gap"]["value"] < 1e-2  # after the epoch: four steps, one a bucket
    assert c["update_gap_median"]["value"] < 1e-3  # after three
    assert res["correct"]


def test_eval_reference_agrees_with_the_port_s_decodes():
    res = tiny_run(EVAL)
    c = res["checks"]
    assert c["rnnt_gap"]["value"] == 0.0 and c["ctc_gap"]["value"] == 0.0
    assert c["missing_answers"]["value"] == 0
    assert res["correct"]


def unchanged(step, opt):
    """A step that returns its state (parameters and AdamW's) unchanged."""
    def s(batch, gen):
        state = [t.detach().clone() for t in opt.params + opt.mu + opt.nu]
        count = opt.count
        aux = step(batch, gen)
        with torch.no_grad():
            for t, b in zip(opt.params + opt.mu + opt.nu, state):
                t.copy_(b)
        opt.count = count
        return aux
    return s


def half_batch(step, opt):
    """Half of the batch left out, the mean taken over the rest."""
    def s(batch, gen):
        n = batch["audio"].shape[0] // 2
        cut = {k: v[:n] if torch.is_tensor(v) and v.dim() else v for k, v in batch.items()}
        cut["n_valid"] = n
        return step(cut, gen)
    return s


def altered(decode):
    """A token altered where it is produced."""
    def d(*args, **kw):
        rows = decode(*args, **kw)
        rows[0] = [(rows[0][0] + 1) % 256] + rows[0][1:] if rows[0] else [7]
        return rows
    return d


@pytest.mark.parametrize("fault", [unchanged, half_batch])
def test_training_faults_fail_the_check(fault):
    assert not tiny_run(TRAIN, step_wrapper=fault)["correct"]


def test_an_altered_token_fails_the_check():
    assert not tiny_run(EVAL, decode_wrapper=altered)["correct"]



def test_large_training_cell_reports_its_rate_per_layer_only():
    """The large training cell holds its tail end to end; its rate is read
    in the traced run under its per-layer name."""
    res = tiny_run(TRAIN)
    assert set(res["metrics"]) == {"train_step_ms_p90", "setup_s"}
    assert res["window"]["audio_s"] > 0
    torch.manual_seed(0)
    res = run(TRAIN, 3, 0.5, True, torch.device("cpu"), overrides=TINY, mix_overrides=MIX)
    assert res["metrics"]["train_audio_s_per_s.traced"]["value"] > 0
    assert res["correct"]
