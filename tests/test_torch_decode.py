"""Port parity: the plain version of the fused greedy RNNT decode kernel
(``indic_cl_asr_torch.ops.decode_fused``: the frame-sync decoder over the
model's own ``pred_step`` / ``joint_step``) against the JAX package's
Pallas kernel in interpret mode and its XLA ``rnnt_greedy_decode``,
token-exact, at ``tiny_config()`` in f32 on the CPU. The cases are those
of tests/test_decode_fused.py: three seeds, the max_out cap, zero-length
rows and T > 128, plus batches that mix languages (each row decoded with
its own language's head, as the CUDA kernel does). The kernel's operands
are held against the JAX package's ``extract_decode_weights``, and greedy
CTC against the JAX decoder. The kernel itself is held against this plain
version on the card by tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.ops.decode_fused_pallas import (
    extract_decode_weights as jax_extract,
)
from indic_cl_asr_tpu.ops.decode_fused_pallas import (
    rnnt_greedy_decode_fused as jax_fused,
)
from indic_cl_asr_tpu.ops.decoding import ctc_greedy_decode as jax_ctc
from indic_cl_asr_tpu.ops.decoding import rnnt_greedy_decode as jax_greedy
from indic_cl_asr_torch.ops.decode_fused import (
    CLUSTER,
    cluster_split,
    extract_decode_weights,
    rnnt_greedy_decode_fused,
    work,
)
from indic_cl_asr_torch.ops.decoding import ctc_greedy_decode

from .test_torch_model import jax_and_port


def _case(seed, B, T, scale, lang, zero_row=False):
    model, jv, port = jax_and_port(seed=seed)
    H = port.cfg.joint_hidden
    rng = np.random.default_rng(seed)
    f_proj = (scale * rng.standard_normal((B, T, H))).astype(np.float32)
    lens = rng.integers(1, T + 1, (B,)).astype(np.int32)
    if zero_row:
        lens[0] = 0
    return model, jv, port, f_proj, lens


CASES = [
    # (seed, B, T, scale, lang, max_symbols, max_out, zero_row)
    (0, 4, 12, 1.0, 0, 4, 16, False),
    (1, 4, 12, 3.0, 2, 4, 16, False),
    (2, 4, 12, 0.3, 1, 4, 16, False),
    (3, 4, 20, 5.0, 0, 2, 4, False),      # max_out cap and symbol budget
    (4, 4, 12, 1.0, 0, 10, 256, True),    # a zero-length row
]


def _xla_greedy(model, jv, f_proj, lens, lang_ids, **kw):
    def pred_step(last, state):
        return model.apply(jv, last, state, method="pred_step")

    def joint_step(f_t, g_t, li):
        return model.apply(jv, f_t, g_t, li, method="joint_step")

    return jax_greedy(
        jnp.asarray(f_proj), jnp.asarray(lens), jnp.asarray(lang_ids),
        pred_step, joint_step, None, **kw,
    )


def _port_fused(port, f_proj, lens, lang_ids, **kw):
    return rnnt_greedy_decode_fused(
        torch.from_numpy(f_proj), torch.from_numpy(lens),
        torch.from_numpy(lang_ids), port, **kw,
    )


@pytest.mark.parametrize("seed,B,T,scale,lang,max_symbols,max_out,zero_row", CASES)
def test_plain_matches_pallas_interpret_and_xla(
    seed, B, T, scale, lang, max_symbols, max_out, zero_row
):
    model, jv, port, f_proj, lens = _case(seed, B, T, scale, lang, zero_row)
    kw = dict(max_symbols=max_symbols, max_out=max_out)
    blank = port.cfg.blank_local
    ids_j, lens_j = jax_fused(
        jnp.asarray(f_proj), jnp.asarray(lens), jax_extract(jv, lang),
        blank=blank, interpret=True, **kw,
    )
    lang_ids = np.full((B,), lang, np.int32)
    ids_t, lens_t = _port_fused(port, f_proj, lens, lang_ids, **kw)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    if zero_row:
        assert int(lens_t[0]) == 0

    ids_x, lens_x = _xla_greedy(model, jv, f_proj, lens, lang_ids, blank=blank, **kw)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_x))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_x))


def test_long_T_matches_xla_greedy():
    """T > 128 (several TPU T-chunks) against the XLA frame-sync decoder."""
    model, jv, port, f_proj, lens = _case(5, 2, 300, 1.5, 0)
    kw = dict(max_symbols=2, max_out=64)
    lang_ids = np.zeros((2,), np.int32)
    ids_j, lens_j = _xla_greedy(
        model, jv, f_proj, lens, lang_ids, blank=port.cfg.blank_local, **kw
    )
    ids_t, lens_t = _port_fused(port, f_proj, lens, lang_ids, **kw)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


@pytest.mark.parametrize("seed,scale", [(6, 1.0), (7, 3.0)])
def test_mixed_language_rows_match_each_language(seed, scale):
    """A batch of rows in different languages decodes each row as the
    JAX kernel decodes that row alone with its language's head, and as the
    XLA frame-sync decoder with per-row languages."""
    B, kw = 6, dict(max_symbols=4, max_out=32)
    model, jv, port, f_proj, lens = _case(seed, B, 14, scale, 0)
    blank = port.cfg.blank_local
    lang_ids = (np.arange(B) * 3 % port.cfg.n_langs).astype(np.int32)
    ids_t, lens_t = _port_fused(port, f_proj, lens, lang_ids, **kw)
    assert int(lens_t.sum()) > 0
    for lang in np.unique(lang_ids):
        rows = np.nonzero(lang_ids == lang)[0]
        ids_j, lens_j = jax_fused(
            jnp.asarray(f_proj[rows]), jnp.asarray(lens[rows]),
            jax_extract(jv, int(lang)), blank=blank, interpret=True, **kw,
        )
        np.testing.assert_array_equal(lens_t.numpy()[rows], np.asarray(lens_j))
        np.testing.assert_array_equal(ids_t.numpy()[rows], np.asarray(ids_j))
    ids_x, lens_x = _xla_greedy(model, jv, f_proj, lens, lang_ids, blank=blank, **kw)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_x))


@pytest.mark.parametrize("lang", [0, 3])
def test_kernel_operands_match_jax_extract(lang):
    """Every language's head sits in the stacked, zero-padded operand; the
    shared weights are the JAX package's, in the kernel's layouts."""
    _, jv, port = jax_and_port(seed=lang)
    w = extract_decode_weights(port)
    wj = {k: np.asarray(v) for k, v in jax_extract(jv, lang).items()}
    V1 = wj["head"].shape[-1]
    for name in ("table", "w_ih", "w_hh", "wp"):
        np.testing.assert_array_equal(w[name].numpy(), wj[name])
    for name in ("bias", "bp"):
        np.testing.assert_array_equal(w[name].numpy(), wj[name][0])
    assert w["head"].shape == (port.cfg.n_langs, port.cfg.joint_hidden, 24)
    np.testing.assert_array_equal(w["head"][lang, :, :V1].numpy(), wj["head"])
    assert not w["head"][:, :, V1:].any()
    np.testing.assert_array_equal(w["head_b"][lang].numpy(), wj["head_b"][0])
    # cached until a parameter changes in place
    assert extract_decode_weights(port) is w
    with torch.no_grad():
        port.joint.head_bias[lang, -1] = 5.0
    w2 = extract_decode_weights(port)
    assert w2 is not w and float(w2["head_b"][lang, -1]) == 5.0


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_greedy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, T, V1 = 3, 25, 6  # a small vocab, so repeats and blanks are common
    lp = rng.standard_normal((B, T, V1)).astype(np.float32)
    lens = np.array([25, 11, 0], np.int32)
    ids_j, lens_j = jax_ctc(jnp.asarray(lp), jnp.asarray(lens))
    ids_t, lens_t = ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(lens))
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def test_work_accounting():
    nbytes, flops = work(2, 3, 8, 8, 5, joint_evals=4, lstm_steps=2,
                         n_langs=2, itemsize=2)
    weights = 4 * 8 + 2 * 8 * 32 + 32 + 8 * 8 + 8
    heads = 2 * (8 * 5 * 2 + 5 * 4)
    assert nbytes == (2 * 3 * 8 + weights) * 2 + heads + 2 * 4 * 2 + 2 * 4 * 2
    assert flops == 2 * 4 * 8 * 5 + 2 * 2 * (2 * 8 * 32 + 8 * 8)


@pytest.mark.parametrize("Hp,Hj,V1,vec,C", [
    (640, 640, 257, 8, CLUSTER),   # flagship bf16: 33 head groups over 8 blocks
    (640, 640, 257, 4, CLUSTER),   # flagship f32
    (32, 32, 17, 8, CLUSTER),      # tiny bf16: fewer groups than blocks
    (32, 32, 17, 4, CLUSTER),
    (640, 640, 257, 8, 16),
    (640, 640, 257, 8, 2),
    (48, 24, 9, 8, 3),
])
def test_cluster_split_owns_every_column_once(Hp, Hj, V1, vec, C):
    """The kernel's split of a row's work over its cluster: every gate,
    projection and head column belongs to exactly one block, in whole
    16-byte groups; a unit's four gate columns share a block; the padded
    head columns lie in the last shares, past every scored column."""
    V1p = -(-V1 // 8) * 8
    sp = cluster_split(Hp, Hj, V1p, vec, C)
    for name, n in (("unit", Hp), ("proj", Hj), ("head", V1p)):
        b = sp[name]
        assert len(b) == C + 1 and b[0] == 0 and b[-1] == n
        assert all(x % vec == 0 for x in b) and all(x <= y for x, y in zip(b, b[1:]))
        # shares differ by at most one group
        sizes = [y - x for x, y in zip(b, b[1:])]
        assert max(sizes) - min(sizes) <= vec

    def owner(bounds, col):
        return [c for c in range(C) if bounds[c] <= col < bounds[c + 1]]

    gates = {}
    for c in range(C):
        for q in range(4):
            for u in range(sp["unit"][c], sp["unit"][c + 1]):
                assert q * Hp + u not in gates
                gates[q * Hp + u] = c
    assert sorted(gates) == list(range(4 * Hp))
    for u in range(Hp):
        assert len({gates[q * Hp + u] for q in range(4)}) == 1
    assert all(len(owner(sp["proj"], j)) == 1 for j in range(Hj))
    # the kernel scores block c's head columns [head[c], min(head[c+1], V1))
    scored = [v for c in range(C) for v in range(sp["head"][c], min(sp["head"][c + 1], V1))]
    assert scored == list(range(V1))
    padded = {owner(sp["head"], v)[0] for v in range(V1, V1p)}
    assert all(c >= owner(sp["head"], V1 - 1)[0] for c in padded)
