"""Port parity of the beam decoders and label-looping greedy decode, at
``tiny_config()`` in f32 on the CPU, with the JAX package's weights carried
across (``from_jax_variables``) and inputs made from numpy seeds:

- ``ctc_prefix_beam_search`` (numpy, the port's own copy): identical prefixes;
- the host Graves beam ``rnnt_beam_search``: identical ids;
- ``rnnt_beam_search_batched`` over beam 1/3/4, a zero-length row, mixed
  languages, unequal lengths and a capping ``max_out``: ids and lens equal,
  scores atol 1e-4 (f32 sums in another order; measured ~1e-6);
- the fused beam's plain version against the JAX Pallas kernel in
  interpret mode (single language, T 10): ids equal, scores atol 1e-4;
- ``rnnt_greedy_decode_labelsync`` against the JAX labelsync and the port's
  frame-sync decoder, windows 1/4/32, with the symbol budget and the
  ``max_out`` cap both hit: identical.

The kernel itself is held against the plain version on the card by
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.ops.beam_fused_pallas import rnnt_beam_search_fused as jax_beam_fused
from indic_cl_asr_tpu.ops.beam_search import ctc_prefix_beam_search as jax_ctc_beam
from indic_cl_asr_tpu.ops.beam_search import rnnt_beam_search as jax_host_beam
from indic_cl_asr_tpu.ops.beam_search import rnnt_beam_search_batched as jax_batched
from indic_cl_asr_tpu.ops.decode_fused_pallas import extract_decode_weights as jax_extract
from indic_cl_asr_tpu.ops.decoding import rnnt_greedy_decode_labelsync as jax_labelsync
from indic_cl_asr_torch.ops.beam_fused import (
    rnnt_beam_search_fused,
    rnnt_beam_search_fused_reference,
    work,
)
from indic_cl_asr_torch.ops.beam_search import (
    ctc_prefix_beam_search,
    rnnt_beam_search,
    rnnt_beam_search_batched,
)
from indic_cl_asr_torch.ops.decoding import (
    rnnt_greedy_decode,
    rnnt_greedy_decode_labelsync,
)

from .test_torch_model import jax_and_port


@pytest.fixture(scope="module")
def models():
    """(flax module, JAX variables, port model, jitted JAX pred_step and
    joint_step): one set of weights for every test of the file."""
    model, jv, port = jax_and_port(seed=0)
    pred = jax.jit(lambda l, s: model.apply(jv, l, s, method="pred_step"))
    joint = jax.jit(lambda f, g, li: model.apply(jv, f, g, li, method="joint_step"))
    return model, jv, port, pred, joint


def _inputs(port, seed, B, T, scale):
    rng = np.random.default_rng(seed)
    f_proj = (scale * rng.standard_normal((B, T, port.cfg.joint_hidden))).astype(np.float32)
    lens = rng.integers(1, T + 1, (B,)).astype(np.int32)
    return f_proj, lens


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_prefix_beam_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, V1 = 14, 6  # a small vocab: repeats and blanks are common
    x = 1.5 * rng.standard_normal((T, V1))
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    for beam, n in ((1, T), (4, T), (8, 9)):
        got = ctc_prefix_beam_search(lp, n, None, beam_size=beam)
        assert got == jax_ctc_beam(lp, n, None, beam_size=beam)


@pytest.mark.parametrize("seed,scale,beam", [(0, 5.0, 3), (0, 12.0, 1)])
def test_host_beam_matches_jax(models, seed, scale, beam):
    _, _, port, pred, joint = models
    f_proj, _ = _inputs(port, seed, 1, 7, scale)
    blank = port.cfg.blank_local
    emitted = 0
    for lang in (0, 2):
        want = jax_host_beam(f_proj[0], 7, lang, pred, joint, blank=blank,
                             beam_size=beam, max_expansions=4)
        got = rnnt_beam_search(torch.from_numpy(f_proj[0]), 7, lang, port.pred_step,
                               port.joint_step, blank=blank, beam_size=beam,
                               max_expansions=4)
        assert got == want
        emitted += len(got)
    assert emitted > 0  # the comparison has content


BATCHED = [
    # (seed, B, T, scale, beam, max_expansions, max_out, zero_row, mixed)
    (0, 4, 10, 1.0, 1, 4, 16, False, False),
    (1, 4, 10, 2.0, 3, 3, 16, True, False),
    (2, 4, 10, 1.0, 4, 4, 16, False, True),
    (3, 3, 12, 3.0, 4, 4, 4, False, False),   # max_out caps every row
    (4, 5, 12, 1.5, 4, 6, 32, True, True),
]


@pytest.mark.parametrize("seed,B,T,scale,beam,max_exp,max_out,zero_row,mixed", BATCHED)
def test_batched_beam_matches_jax(models, seed, B, T, scale, beam, max_exp, max_out, zero_row,
                                  mixed):
    _, _, port, pred, joint = models
    f_proj, lens = _inputs(port, seed, B, T, scale)
    if zero_row:
        lens[0] = 0
    n_langs = port.cfg.n_langs
    lang = (np.arange(B) * 3 % n_langs if mixed else np.full((B,), seed % n_langs)).astype(np.int32)
    kw = dict(blank=port.cfg.blank_local, beam_size=beam, max_expansions=max_exp,
              max_out=max_out)
    ids_j, lens_j, sc_j = jax_batched(jnp.asarray(f_proj), jnp.asarray(lens),
                                      jnp.asarray(lang), pred, joint, None, **kw)
    ids_t, lens_t, sc_t = rnnt_beam_search_batched(*_t(f_proj, lens, lang), port.pred_step,
                                                   port.joint_step, None, **kw)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=0, atol=1e-4)
    assert ids_t.dtype == lens_t.dtype == torch.int32 and sc_t.dtype == torch.float32
    assert int(lens_t.sum()) > 0
    if zero_row:
        assert int(lens_t[0]) == 0 and float(sc_t[0]) == 0.0
    if max_out == 4:
        assert int(lens_t.max()) == max_out


def test_fused_plain_matches_pallas_interpret(models):
    """The fused beam's plain version (the wrapper on CPU tensors) against
    the JAX Pallas kernel in interpret mode, as tests/test_beam_fused.py
    runs it, on a single-language batch."""
    _, jv, port, _, _ = models
    f_proj, lens = _inputs(port, 5, 3, 10, 1.0)
    lang = 2
    kw = dict(beam_size=4, max_expansions=4, max_out=16)
    ids_j, lens_j, sc_j = jax_beam_fused(
        jnp.asarray(f_proj), jnp.asarray(lens), jax_extract(jv, lang),
        blank=port.cfg.blank_local, interpret=True, **kw,
    )
    ids_t, lens_t, sc_t = rnnt_beam_search_fused(
        *_t(f_proj, lens, np.full((3,), lang, np.int32)), port, **kw)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=0, atol=1e-4)
    assert int(lens_t.sum()) > 0


def test_rows_stopping_early_change_nothing(models):
    """The kernel stops a row's rounds when that row is done; the plain
    version loops while any row of the batch is live. Rows of unequal
    lengths decoded together give what each gives alone."""
    port = models[2]
    f_proj, _ = _inputs(port, 6, 4, 12, 1.5)
    lens = np.array([12, 3, 7, 1], np.int32)
    lang = np.array([0, 1, 2, 3], np.int32)
    kw = dict(beam_size=4, max_expansions=5, max_out=32)
    trace = []
    ids, n, sc = rnnt_beam_search_fused_reference(*_t(f_proj, lens, lang), port,
                                                  trace=trace, **kw)
    assert trace and all(t.shape == (4,) for t in trace)
    for r in range(4):
        ids_r, n_r, sc_r = rnnt_beam_search_fused_reference(
            *_t(f_proj[r:r + 1], lens[r:r + 1], lang[r:r + 1]), port, **kw)
        assert torch.equal(ids_r[0], ids[r]) and int(n_r[0]) == int(n[r])
        assert abs(float(sc_r[0]) - float(sc[r])) <= 1e-5 * abs(float(sc[r]))


def test_stable_sort_takes_the_lowest_index_among_ties():
    """The beam selects with a stable descending sort: among equal values
    (NEG ties are certain) the lowest index first, as ``lax.top_k``."""
    x = torch.tensor([[-1e30, 2.0, -1e30, 2.0, 5.0, -1e30]])
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    assert idx[:, :5].tolist() == [[4, 1, 3, 0, 2]]
    neg = torch.tensor(-1e30).item()  # NEG as f32 holds it
    assert vals[:, :5].tolist() == [[5.0, 2.0, 2.0, neg, neg]]


LABELSYNC = [
    # (seed, B, T, scale, max_symbols, max_out, zero_row)
    (0, 4, 12, 1.0, 4, 16, False),
    (3, 4, 20, 5.0, 2, 4, False),   # the symbol budget and max_out both bind
    (4, 4, 12, 3.0, 1, 6, True),
]


@pytest.mark.parametrize("seed,B,T,scale,max_symbols,max_out,zero_row", LABELSYNC)
def test_labelsync_matches_jax_and_framesync(models, seed, B, T, scale, max_symbols, max_out,
                                             zero_row):
    _, _, port, pred, joint = models
    f_proj, lens = _inputs(port, seed, B, T, scale)
    if zero_row:
        lens[0] = 0
    lang = (np.arange(B) % port.cfg.n_langs).astype(np.int32)
    kw = dict(blank=port.cfg.blank_local, max_symbols=max_symbols, max_out=max_out)
    ids_f, lens_f = rnnt_greedy_decode(*_t(f_proj, lens, lang), port.pred_step,
                                       port.joint_step, None, **kw)
    assert int(lens_f.sum()) > 0
    if max_out == 4:
        assert int(lens_f.max()) == max_out
    for window in (1, 4, 32):
        ids_j, lens_j = jax_labelsync(jnp.asarray(f_proj), jnp.asarray(lens),
                                      jnp.asarray(lang), pred, joint, None, window=window,
                                      **kw)
        ids_t, lens_t = rnnt_greedy_decode_labelsync(
            *_t(f_proj, lens, lang), port.pred_step, port.joint_step, None, window=window,
            **kw)
        np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        assert torch.equal(ids_t, ids_f) and torch.equal(lens_t, lens_f)


def test_work_accounting():
    nbytes, flops = work(2, 3, 8, 8, 5, joint_evals=4, lstm_steps=2, n_langs=2, itemsize=2)
    weights = 4 * 8 + 2 * 8 * 32 + 32 + 8 * 8 + 8
    heads = 2 * (8 * 5 * 2 + 5 * 4)
    assert nbytes == (2 * 3 * 8 + weights) * 2 + heads + 2 * 4 * 2 + 3 * 4 * 2
    assert flops == 2 * 4 * 8 * 5 + 2 * 2 * (2 * 8 * 32 + 8 * 8)
