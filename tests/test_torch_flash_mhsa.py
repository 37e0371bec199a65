"""Port parity: the plain version of the flash rel-pos attention kernel
(``indic_cl_asr_torch.ops.flash_mhsa``) against the JAX package's Pallas
kernel in interpret mode and its XLA oracle ``relpos_attention_reference``,
in f32 on the CPU, atol 1e-5. Cases cover a row with lens=0, T=1 and
(left, right) bands. The kernel itself is held against this plain version
on the card by tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.ops.flash_mhsa import flash_relpos_mhsa as jax_flash
from indic_cl_asr_tpu.ops.flash_mhsa import relpos_attention_reference
from indic_cl_asr_torch.ops.flash_mhsa import (
    flash_relpos_mhsa,
    flash_relpos_mhsa_reference,
    work,
)

ATOL = 1e-5


def _inputs(seed, B, T, H, D, lens):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H * D)).astype(np.float32) for _ in range(3))
    p = rng.standard_normal((2 * T - 1, H * D)).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    vb = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    return q, k, v, p, u, vb, np.asarray(lens, np.int32)


def _port(args, H, **kw):
    return flash_relpos_mhsa_reference(
        *(torch.from_numpy(a) for a in args), n_heads=H, **kw
    ).numpy()


CASES = [
    # (T, H, D, lens, (left, right))
    (37, 2, 16, [37, 0, 20], (-1, -1)),
    (1, 2, 16, [1, 0], (-1, -1)),
    (40, 4, 16, [40, 33], (16, 0)),
    (70, 2, 32, [70, 50], (20, 10)),
    (23, 1, 16, [23, 5], (-1, 3)),
]


@pytest.mark.parametrize("T,H,D,lens,band", CASES)
def test_plain_matches_xla_oracle(T, H, D, lens, band):
    B = len(lens)
    args = _inputs(T, B, T, H, D, lens)
    left, right = band
    out = _port(args, H, left=left, right=right)
    q, k, v, p, u, vb, ln = args
    ref = relpos_attention_reference(
        jnp.asarray(q.reshape(B, T, H, D)), jnp.asarray(k.reshape(B, T, H, D)),
        jnp.asarray(v.reshape(B, T, H, D)), jnp.asarray(p.reshape(-1, H, D)),
        jnp.asarray(u), jnp.asarray(vb), jnp.asarray(ln), left=left, right=right,
    )
    np.testing.assert_allclose(out, np.asarray(ref).reshape(B, T, H * D), atol=ATOL)
    # rows past the valid length, and every row of a lens=0 row, are zero
    for b, n in enumerate(lens):
        assert np.abs(out[b, n:]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("T,H,D,lens,band", CASES[:3])
def test_plain_matches_pallas_interpret(T, H, D, lens, band):
    B = len(lens)
    args = _inputs(T + 100, B, T, H, D, lens)
    left, right = band
    out = _port(args, H, left=left, right=right)
    ref = jax_flash(
        *(jnp.asarray(a) for a in args), n_heads=H, left=left, right=right,
        interpret=True,
    )
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


def test_wrapper_on_cpu_takes_plain_version_and_checks_inputs():
    args = [torch.from_numpy(a) for a in _inputs(5, 2, 12, 2, 16, [12, 7])]
    before = flash_relpos_mhsa.launches
    out = flash_relpos_mhsa(*args, n_heads=2)
    assert torch.equal(out, flash_relpos_mhsa_reference(*args, n_heads=2))
    assert flash_relpos_mhsa.launches == before  # no kernel launched on the CPU
    dropped = flash_relpos_mhsa(*args, n_heads=2, dropout_rate=0.1, seed=3)
    assert torch.equal(dropped, flash_relpos_mhsa_reference(
        *args, n_heads=2, dropout_rate=0.1, seed=3))
    assert not torch.equal(dropped, out)
    with pytest.raises(ValueError):
        flash_relpos_mhsa(*args, n_heads=2, dropout_rate=1.0)
    with pytest.raises(ValueError):
        flash_relpos_mhsa(*args[:3], args[3][:-1], *args[4:], n_heads=2)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        flash_relpos_mhsa(*meta, n_heads=2)


def test_work_counts_visible_pairs():
    nbytes, flops = work(2, 4, 8, [4, 2], itemsize=2)
    assert nbytes == (4 * 2 * 4 * 8 + 7 * 8) * 2
    assert flops == 3 * 2 * (16 + 4) * 8
    _, banded = work(1, 4, 8, [4], left=0, right=0)
    assert banded == 3 * 2 * 4 * 8
