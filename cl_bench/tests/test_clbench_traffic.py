"""The seed changes the content of a mix and never the amount of work."""

import numpy as np
import pytest
import torch

from cl_bench import traffic
from cl_bench.run import load

SEEDS = (7, 2**31 + 11)


@pytest.mark.parametrize("name", ["cl_task", "wer_eval"])
def test_plan_and_token_counts_are_the_mix_s(name):
    mix = load("traffic", name)
    plans = [traffic.plan(mix) for _ in SEEDS]
    assert plans[0] == plans[1]
    samples = [p[3] for p in plans[0]]
    assert len(set(samples)) == len(samples)  # a row's utterance is found by its length
    texts = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        got = [traffic.transcript(traffic.token_count(n, mix), rng) for *_, n in plans[0]]
        assert [len(ids) for ids, _ in got] == [traffic.token_count(n, mix) for *_, n in plans[0]]
        for (lang, s, b, n), (ids, _) in zip(plans[0], got):
            assert len(ids) <= mix["bucket_max_tokens"][b]
            assert (ids[1:] != ids[:-1]).all()  # no repeats: every CTC target fits
        texts.append([t for _, t in got])
    assert texts[0] != texts[1]
    for b, (lo, hi, n) in enumerate(mix["buckets"]):
        assert n % mix["batch_size"] == 0


def test_two_seeds_give_the_same_work_and_other_samples(tmp_path):
    mix = load("traffic", "cl_task")
    runs = [traffic.generate(mix, s, str(tmp_path / str(s)), torch.device("cpu")) for s in SEEDS]
    work = [traffic.work_summary(u, mix) for u in runs]
    assert work[0] == work[1]
    a, b = (traffic.read_wav(r[0].path) for r in runs)
    assert a.shape == b.shape and not np.array_equal(a, b)
    assert any(not np.array_equal(x.ids, y.ids) for x, y in zip(*runs))


def test_the_port_reads_the_mix_into_the_same_batches(tmp_path):
    """Through the port's BatchPipeline and tokenizer: the same batches per
    bucket, padded shapes, real audio seconds and token counts."""
    from cl_bench.cells import LANGUAGES, bucket_spec, entries, tokenizer
    from indic_cl_asr_torch.data.pipeline import BatchPipeline

    mix = load("traffic", "cl_task")
    seen = []
    for s in SEEDS:
        utts = traffic.generate(mix, s, str(tmp_path / str(s)), torch.device("cpu"))
        tok = tokenizer(mix["languages"])
        for u in utts:
            assert tok.text_to_ids(u.text, u.lang) == u.ids.tolist()
        pipe = BatchPipeline(entries(utts), tok, LANGUAGES, mix["batch_size"],
                             spec=bucket_spec(mix), shuffle=True, seed=s)
        batches = list(pipe)
        seen.append((sorted((b.audio.shape, b.tokens.shape, b.n_real) for b in batches),
                     sum(int(b.audio_len.sum()) for b in batches),
                     sum(int(b.token_len.sum()) for b in batches)))
    assert seen[0] == seen[1]
