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
- a CPU model of the fused beam kernel's cross-block merge (each block of
  a row's cluster sends its partial log-softmax and top-P, every block
  merges them in rank order) against the global top-P and lse, with equal
  values planted on both sides of the blocks' column boundaries: the same
  indices, values atol 1e-6;
- a merge-predicate tie: the batched beam where equal label sequences
  score exactly alike, so the logaddexp merge fires, the top-K meets exact
  ties and the merged mass decides the best, against the JAX package's:
  ids and lens equal, scores atol 1e-5;
- ``rnnt_greedy_decode_labelsync`` against the JAX labelsync and the port's
  frame-sync decoder, windows 1/4/32, with the symbol budget and the
  ``max_out`` cap both hit: identical.

The kernel itself is held against the plain version on the card by
tests/test_torch_kernels_gpu.py.
"""

import math

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
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, init_weights_, tiny_config
from indic_cl_asr_torch.ops.beam_fused import (
    beam_weights,
    rnnt_beam_search_fused,
    rnnt_beam_search_fused_reference,
    work,
)
from indic_cl_asr_torch.ops.beam_search import (
    NEG,
    ctc_prefix_beam_search,
    rnnt_beam_search,
    rnnt_beam_search_batched,
)
from indic_cl_asr_torch.ops.decode_fused import cluster_split, extract_decode_weights
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


NONE = 0x7FFFFFFF


def _cluster_merge(x, blank, P, C, vec):
    """A model of the fused beam kernel's joint merge (csrc/beam_fused.cu:
    joint_partials and merge_partials) for one hypothesis's f32 logits x
    [V1]: each of the C blocks of a row's cluster holds the head columns
    ``cluster_split`` gives it (the padded ones unscored) and sends its
    (max, sum of exp(x - max)), its top-P non-blank (logit, index) by the
    larger logit then the lower index (padded with (-inf, NONE)) and, in
    the block that owns it, the blank's logit; the merge runs over the
    blocks in rank order: m = max, s = sum s_c·exp(m_c - m), lse = log s,
    lp = (x - m) - lse, and the top-P of the C·P candidates and the blank
    at NEG by (lp, then the lower index). Returns (lse, blank lp, [(lp,
    index)] * P)."""
    V1 = x.numel()
    bounds = cluster_split(8, 8, -(-V1 // 8) * 8, vec, C)["head"]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    recs = []
    for c in range(C):
        lo, hi = bounds[c], min(bounds[c + 1], V1)
        cols = x[lo:hi]
        m_c = cols.max() if hi > lo else f32(-math.inf)
        s_c = torch.exp(cols - m_c).sum() if hi > lo else f32(0.0)
        nb = sorted(((float(x[v]), v) for v in range(lo, hi) if v != blank),
                    key=lambda e: (-e[0], e[1]))[:P]
        recs.append((m_c, s_c, nb + [(-math.inf, NONE)] * (P - len(nb))))
    owner = next(c for c in range(C) if bounds[c] <= blank < bounds[c + 1])
    m = max(r[0] for r in recs)
    total = f32(0.0)
    for m_c, s_c, _ in recs:  # rank order
        total = total + s_c * torch.exp(m_c - m)
    lse = torch.log(total)
    cands = [(float((f32(v) - m) - lse), i) for r in recs for v, i in r[2]]
    cands.append((float(f32(NEG)), blank))  # NEG as f32 holds it
    cands.sort(key=lambda e: (-e[0], e[1]))
    assert recs[owner][0] >= x[blank]
    return lse, float((x[blank] - m) - lse), cands[:P]


MERGE_CASES = [
    # (V1, vec, P, planted ties {index: value}): flagship's 257 classes in
    # bf16 groups (block bounds 32, 64, ..., 224), ties on both sides of
    # the boundaries 32 and 96 (the second across the P-th place) and
    # inside one block; the tiny width's 17 classes in f32 groups (two
    # blocks of the eight hold no column) with P = V1, where the blank at
    # NEG closes the top-P
    (257, 8, 4, {10: 9.0, 31: 8.0, 32: 8.0, 95: 7.0, 96: 7.0}),
    (257, 8, 16, {63: 6.5, 64: 6.5, 200: 6.5, 201: 6.5, 223: 6.0, 224: 6.0}),
    (257, 4, 8, {127: 5.0, 128: 5.0, 129: 5.0}),
    (17, 4, 17, {3: 4.0, 4: 4.0, 8: 4.0}),
    (17, 4, 3, {7: 3.0, 8: 3.0, 12: 3.0}),
]


@pytest.mark.parametrize("V1,vec,P,ties", MERGE_CASES)
def test_cluster_merge_equals_the_global_top_p_and_lse(V1, vec, P, ties):
    """The kernel's cross-block merge against the plain version's
    selection over the whole row: the same top-P indices, lowest index
    first among equal values even where they sit in two blocks, and
    log-probs and lse equal but for the last bits the block-wise sum moves
    (atol 1e-6)."""
    rng = np.random.default_rng(V1 + P)
    x = torch.from_numpy((2.0 * rng.standard_normal(V1)).astype(np.float32))
    for i, v in ties.items():
        x[i] = v
    blank = V1 - 1
    lse, lp_blank, top = _cluster_merge(x, blank, P, 8, vec)
    # the plain version (ops/beam_search.py): log_softmax, the blank at NEG,
    # a stable descending sort
    z = x - x.max()
    lse_g = torch.log(torch.exp(z).sum())
    lp = z - lse_g
    lp_nb = lp.clone()
    lp_nb[blank] = NEG
    vals, order = torch.sort(lp_nb, descending=True, stable=True)
    assert [i for _, i in top] == order[:P].tolist()
    assert max(abs(v - float(w)) for (v, _), w in zip(top, vals[:P])) <= 1e-6
    assert abs(float(lse) - float(lse_g)) <= 1e-6
    assert abs(lp_blank - float(lp[blank])) <= 1e-6
    # the planted ties were decided: each tied group's lower index first
    tied = sorted(i for i in ties if i in order[:P].tolist())
    assert tied == [i for _, i in top if i in ties]
    if P == V1:
        assert top[-1] == (float(vals[P - 1]), blank)


def _merge_tie_models(d_token, seed, B, T):
    """The tiny model with its joint's pred projection zeroed (g, hence
    every frame's log-probs, no longer depend on the history) and each
    row's head bias set so the blank leads, token 3 trails it by
    ``d_token``, token 5 by 2 and the rest by 10; f_proj one vector a row
    repeated over T frames. Two label sequences that emit the same tokens
    in other frames then score exactly alike (f32 addition commutes), so
    the beam holds equal sequences the merge must combine, and top-K ties
    the lowest index must break. Returns the JAX steps, the port, f_proj
    and the language ids."""
    model, jv, port = jax_and_port(seed=0)
    rng = np.random.default_rng(seed)
    H = port.cfg.joint_hidden
    v = rng.standard_normal((B, 1, H)).astype(np.float32)
    lang = np.arange(B).astype(np.int32) % port.cfg.n_langs
    params = jax.tree.map(np.asarray, jv["params"])
    joint_p = dict(params["joint"])
    joint_p["pred"] = dict(joint_p["pred"], kernel=np.zeros_like(joint_p["pred"]["kernel"]))
    hk, hb = joint_p["head_kernel"], np.array(joint_p["head_bias"])
    for b in range(B):
        x = np.maximum(v[b, 0] + joint_p["pred"]["bias"], 0) @ hk[lang[b]]
        hb[lang[b]] = -8.0 - x
        hb[lang[b], -1] = 2.0 - x[-1]
        hb[lang[b], 3] = 2.0 - d_token - x[3]
        hb[lang[b], 5] = -x[5]
    joint_p["head_bias"] = hb.astype(np.float32)
    jv = dict(jv, params=jax.tree.map(jnp.asarray, dict(params, joint=joint_p)))
    with torch.no_grad():
        port.joint.pred.weight.zero_()
        port.joint.head_bias.copy_(torch.from_numpy(joint_p["head_bias"]))
    pred = jax.jit(lambda l, s: model.apply(jv, l, s, method="pred_step"))
    joint = jax.jit(lambda f, g, li: model.apply(jv, f, g, li, method="joint_step"))
    return pred, joint, port, np.repeat(v, T, axis=1), lang


@pytest.mark.parametrize("d_token,seed", [(0.3, 0), (0.0, 1)])
def test_batched_beam_merge_decides_a_tie_as_jax(monkeypatch, d_token, seed):
    """Equal label sequences reached through other frames score exactly
    alike: the logaddexp merge fires (counted), the top-K meets exact ties
    (a decision gap of 0 in the trace) and the merged mass decides the
    best hypothesis (without it the best is another). The port's batched
    beam equals the JAX package's: ids and lens, scores atol 1e-5."""
    B, T = 3, 5
    pred, joint, port, f_proj, lang = _merge_tie_models(d_token, seed, B, T)
    lens = np.full((B,), T, np.int32)
    kw = dict(blank=port.cfg.blank_local, beam_size=4, max_expansions=3, max_out=16)
    ids_j, lens_j, sc_j = jax_batched(jnp.asarray(f_proj), jnp.asarray(lens),
                                      jnp.asarray(lang), pred, joint, None, **kw)
    logaddexp, merges = torch.logaddexp, []
    monkeypatch.setattr(torch, "logaddexp",
                        lambda a, b: merges.append(1) or logaddexp(a, b))
    trace = []
    args = (*_t(f_proj, lens, lang), port.pred_step, port.joint_step, None)
    ids_t, lens_t, sc_t = rnnt_beam_search_batched(*args, trace=trace, **kw)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=0, atol=1e-5)
    assert merges and float(torch.stack(trace).amin()) == 0.0
    monkeypatch.setattr(torch, "logaddexp", torch.maximum)  # no merged mass
    ids_m, lens_m, _ = rnnt_beam_search_batched(*args, **kw)
    assert not torch.equal(lens_m, lens_t)


def test_beam_weights_transpose_the_bf16_mat_vecs():
    """The fused beam's operands: in f32 the decode weights themselves; in
    bf16 the mat-vec weights transposed for the tensor cores (a row per
    output column, its depth contiguous), cached until a parameter
    changes."""
    for dt in (torch.float32, torch.bfloat16):
        model = init_weights_(HybridRNNTCTC(tiny_config(dtype=dt), device="cpu"),
                              torch.Generator().manual_seed(0))
        w, t = extract_decode_weights(model), beam_weights(model)
        if dt == torch.float32:
            assert t is w
            continue
        for name in ("w_ih", "w_hh", "wp"):
            assert t[name].is_contiguous() and torch.equal(t[name], w[name].t()), name
        assert torch.equal(t["head"], w["head"].transpose(1, 2)) and t["head"].is_contiguous()
        assert t["table"] is w["table"] and t["head_b"] is w["head_b"]
        assert beam_weights(model) is t
        with torch.no_grad():
            model.joint.head_kernel.mul_(2.0)
        t2 = beam_weights(model)
        assert t2 is not t and torch.equal(t2["head"], extract_decode_weights(model)["head"].transpose(1, 2))


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
