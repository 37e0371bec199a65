"""Port parity of the flash rel-pos attention backward: the plain version's
gradients (autograd through ``flash_relpos_mhsa_reference``, the backward
kernel's plain version) for q, k, v, p, bias_u and bias_v against
``jax.grad`` of the JAX package's Pallas kernel in interpret mode (its
``_bwd_kernel``) and of its XLA oracle ``relpos_attention_reference``, in
f32 on the CPU, atol 1e-5. Cases cover a row with lens=0, T=1 and bands.

The dropout bits the kernels draw (a murmur3-finaliser hash of
(seed, b, h, t, j)) are checked here on their plain version: the same per
seed, different per seed and per (b, h), and a keep rate within 5e-3 of
1 - rate. The kernel's bits are held equal to these on the card by
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.ops.flash_mhsa import flash_relpos_mhsa as jax_flash
from indic_cl_asr_tpu.ops.flash_mhsa import relpos_attention_reference
from indic_cl_asr_torch.ops.flash_mhsa import (
    dropout_bits,
    flash_relpos_mhsa,
    flash_relpos_mhsa_backward,
    flash_relpos_mhsa_backward_reference,
    keep_threshold,
)

ATOL = 1e-5
NAMES = ("q", "k", "v", "p", "bias_u", "bias_v")


def _inputs(seed, B, T, H, D, lens):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H * D)).astype(np.float32) for _ in range(3))
    p = rng.standard_normal((2 * T - 1, H * D)).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    vb = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    dout = rng.standard_normal((B, T, H * D)).astype(np.float32)
    return (q, k, v, p, u, vb, np.asarray(lens, np.int32)), dout


def _port_grads(args, dout, H, **kw):
    t = [torch.from_numpy(a) for a in args]
    grads = flash_relpos_mhsa_backward_reference(*t, torch.from_numpy(dout), n_heads=H, **kw)
    return [g.numpy() for g in grads]


CASES = [
    # (T, H, D, lens, (left, right))
    (37, 2, 16, [37, 0, 20], (-1, -1)),
    (1, 2, 16, [1, 0], (-1, -1)),
    (40, 4, 16, [40, 33], (16, 0)),
    (23, 1, 16, [23, 5], (-1, 3)),
]


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla_reference"])
@pytest.mark.parametrize("T,H,D,lens,band", CASES)
def test_plain_backward_matches_jax_grad(oracle, T, H, D, lens, band):
    B = len(lens)
    args, dout = _inputs(T + 7, B, T, H, D, lens)
    left, right = band
    got = _port_grads(args, dout, H, left=left, right=right)
    ln = jnp.asarray(args[6])

    if oracle == "pallas_interpret":
        def f(q, k, v, p, u, vb):
            return jax_flash(q, k, v, p, u, vb, ln, n_heads=H, left=left,
                             right=right, interpret=True)
    else:
        def f(q, k, v, p, u, vb):
            out = relpos_attention_reference(
                q.reshape(B, T, H, D), k.reshape(B, T, H, D), v.reshape(B, T, H, D),
                p.reshape(-1, H, D), u, vb, ln, left=left, right=right)
            return out.reshape(B, T, H * D)

    leaves = [jnp.asarray(a) for a in args[:6]]
    want = jax.jit(lambda d, *x: jax.vjp(f, *x)[1](d))(jnp.asarray(dout), *leaves)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, err_msg=name)


def test_cpu_autograd_through_wrapper_is_the_plain_backward():
    args, dout = _inputs(3, 2, 12, 2, 16, [12, 7])
    t = [torch.from_numpy(a) for a in args]
    leaves = [x.clone().requires_grad_(True) for x in t[:6]]
    before = flash_relpos_mhsa_backward.launches
    out = flash_relpos_mhsa(*leaves, t[6], n_heads=2, dropout_rate=0.1, seed=5)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    want = flash_relpos_mhsa_backward_reference(
        *t, torch.from_numpy(dout), n_heads=2, dropout_rate=0.1, seed=5)
    assert flash_relpos_mhsa_backward.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        flash_relpos_mhsa_backward(*t, None, torch.from_numpy(dout), n_heads=2)


def test_dropout_bits_deterministic_distinct_and_at_rate():
    B, H, T = 2, 4, 50
    a = dropout_bits(1234, B, H, T)
    assert torch.equal(a, dropout_bits(1234, B, H, T))
    assert a.min() >= 0 and a.max() < 2**32
    assert not torch.equal(a, dropout_bits(1235, B, H, T))
    rows = a.reshape(B * H, T * T)
    for i in range(B * H):
        for j in range(i + 1, B * H):
            assert (rows[i] == rows[j]).float().mean() < 0.01
    for rate in (0.1, 0.25):
        keep = (dropout_bits(99, 4, 8, 64) <= keep_threshold(rate)).double().mean().item()
        assert abs(keep - (1.0 - rate)) < 5e-3, (rate, keep)
