"""Port parity of the fused joint (ops/joint_fused.py, the plain version of
the CUDA kernels), the ``impl="pallas"`` and ``remat="save_logits"`` paths
of ``rnnt_loss_fused`` and ``ctc_loss(impl="optax")`` against the JAX
package, on the CPU.

The JAX reference is ``joint_slabs_pallas(..., interpret=True)``, as
tests/test_joint_fused_pallas.py runs it, with dropout 0: the TPU PRNG does
not run in interpret mode, and the port's dropout bits are its own hash
(held to the kernels' bits on the card by tests/test_torch_kernels_gpu.py).

Tolerances: f32 slabs and the gradients of f, g, W and b atol 1e-5 (f32
sums in another order). bf16 f and g with an f32 head: the joint input is
rounded to bf16 the same way on both sides and the products are exact in
f32, so the slabs and dW/db keep atol 1e-5; df and dg are rounded to bf16
(one step is 2^-8 of the value), and the JAX kernel adds dg into a bf16
buffer chunk by chunk where the port rounds an f32 sum once, so they are
held to 2e-2 of max|ref|. The losses: value atol 1e-5, gradients rtol
1e-5 + atol 1e-5.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from indic_cl_asr_tpu.ops.joint_fused_pallas import joint_slabs_pallas
from indic_cl_asr_tpu.ops.rnnt_loss_fused import rnnt_loss_fused as jax_rnnt_loss_fused
from indic_cl_asr_torch.ops import joint_fused as J
from indic_cl_asr_torch.ops.ctc_loss import ctc_loss
from indic_cl_asr_torch.ops.rnnt_loss_fused import rnnt_loss_fused


def _case(seed, B=3, T=21, U1=6, H=24, V1=11, langs=2):
    """Per-row heads gathered from ``langs`` languages' heads."""
    rng = np.random.default_rng(seed)
    f = (0.5 * rng.standard_normal((B, T, H))).astype(np.float32)
    g = (0.5 * rng.standard_normal((B, U1, H))).astype(np.float32)
    heads = (0.5 * rng.standard_normal((langs, H, V1))).astype(np.float32)
    hb = (0.1 * rng.standard_normal((langs, V1))).astype(np.float32)
    lang = np.arange(B) % langs
    labels = rng.integers(0, V1 - 1, (B, U1)).astype(np.int32)
    labels[:, -1] = 0  # the pad column, as rnnt_loss_fused builds it
    dlpb = rng.standard_normal((B, T, U1)).astype(np.float32)
    dlpl = rng.standard_normal((B, T, U1)).astype(np.float32)
    return f, g, heads[lang], hb[lang], labels, dlpb, dlpl


def _t(*a):
    return [torch.from_numpy(np.asarray(x)) for x in a]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,chunk", [(21, 8), (16, 16), (5, 16)])
def test_joint_slabs_match_jax_interpret(dtype, T, chunk):
    """Slabs and the four gradients, T a multiple of the JAX chunk and not,
    rows on two languages' heads."""
    f, g, w, b, labels, dlpb, dlpl = _case(T, T=T)
    blank = w.shape[-1] - 1
    jdt = jnp.dtype(dtype)

    def jfn(f_, g_, w_, b_):
        lpb, lpl = joint_slabs_pallas(f_.astype(jdt), g_.astype(jdt), w_, b_,
                                      jnp.asarray(labels), jnp.zeros((1,), jnp.int32),
                                      blank, chunk, 0.0, True)
        return lpb, lpl

    (jpb, jpl), vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (f, g, w, b)))
    jgrads = vjp((jnp.asarray(dlpb), jnp.asarray(dlpl)))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(f).to(tdt).requires_grad_(True),
              torch.from_numpy(g).to(tdt).requires_grad_(True),
              *(t.requires_grad_(True) for t in _t(w, b))]
    lpb, lpl = J.joint_slabs(*leaves, torch.from_numpy(labels), 0, blank=blank)
    grads = torch.autograd.grad((lpb * torch.from_numpy(dlpb) + lpl * torch.from_numpy(dlpl)).sum(),
                                leaves)
    np.testing.assert_allclose(lpb.detach().numpy(), np.asarray(jpb), atol=1e-5)
    np.testing.assert_allclose(lpl.detach().numpy(), np.asarray(jpl), atol=1e-5)
    for name, got, want in zip(("df", "dg", "dW", "db"), grads, jgrads):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == leaves[("df", "dg", "dW", "db").index(name)].dtype
        got = got.float().numpy()
        if dtype == "bfloat16" and name in ("df", "dg"):
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), name
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)


def test_joint_slabs_dropout_bits_and_mask():
    """The plain version's dropout: bits that depend on (seed, b, t, u, h)
    only, the keep rate of the threshold, and a hand-written backward that
    applies the forward's mask: its gradients equal autograd through the
    same forward written out (relu, the mask of ``dropout_bits``, the
    scale, the head, log-softmax, gather), atol 1e-5."""
    bits = J.dropout_bits(11, 2, 5, 7, 0, 9)
    assert torch.equal(bits[:, 3:6], J.dropout_bits(11, 2, 5, 7, 3, 6))
    assert not torch.equal(bits, J.dropout_bits(12, 2, 5, 7, 0, 9))
    keep = (J.dropout_bits(3, 4, 33, 64, 0, 40) <= J.keep_threshold(0.2)).double().mean()
    assert abs(float(keep) - 0.8) < 5e-3
    f, g, w, b, labels, dlpb, dlpl = _case(2, T=19)
    B, T, H = f.shape
    U1, V1 = g.shape[1], w.shape[2]
    rate, seed = 0.3, 77
    lab = torch.from_numpy(labels)
    cot = _t(dlpb, dlpl)

    leaves = [t.requires_grad_(True) for t in _t(f, g, w, b)]
    lpb, lpl = J.joint_slabs(*leaves, lab, seed, blank=V1 - 1, dropout_rate=rate)
    got = torch.autograd.grad((lpb * cot[0] + lpl * cot[1]).sum(), leaves)

    ref_leaves = [t.requires_grad_(True) for t in _t(f, g, w, b)]
    rf, rg, rw, rb = ref_leaves
    keep_mask = J.dropout_bits(seed, B, U1, H, 0, T) <= J.keep_threshold(rate)
    x = torch.where(keep_mask, torch.relu(rf[:, :, None] + rg[:, None]) * (1 / (1 - rate)), 0.0)
    z = torch.einsum("btuh,bhv->btuv", x, rw) + rb[:, None, None]
    lp = torch.log_softmax(z, -1)
    want_pb = lp[..., V1 - 1]
    want_pl = torch.gather(lp, 3, lab.long()[:, None, :, None].expand(B, T, U1, 1))[..., 0]
    want = torch.autograd.grad((want_pb * cot[0] + want_pl * cot[1]).sum(), ref_leaves)
    np.testing.assert_allclose(lpb.detach().numpy(), want_pb.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(lpl.detach().numpy(), want_pl.detach().numpy(), atol=1e-5)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5)
    no_drop = J.joint_slabs(*_t(f, g, w, b), lab, seed, blank=V1 - 1)[0]
    assert not torch.allclose(lpb.detach(), no_drop)


@pytest.mark.parametrize("masked", [False, True])
def test_rnnt_loss_pallas_matches_jax_interpret(masked):
    rng = np.random.default_rng(8)
    B, T, U, H, V1 = 3, 13, 4, 16, 9
    f, g, w, b, _, _, _ = _case(8, B=B, T=T, U1=U + 1, H=H, V1=V1)
    labels = rng.integers(0, V1 - 1, (B, U)).astype(np.int32)
    fl, ul = np.array([T, T - 4, 2], np.int32), np.array([U, 2, 0], np.int32)
    mask = np.array([True, True, False]) if masked else None
    kw = dict(blank=V1 - 1, chunk_size=8)

    def jloss(f_, g_, w_, b_):
        return jax_rnnt_loss_fused(f_, g_, w_, b_, jnp.asarray(labels), jnp.asarray(fl),
                                   jnp.asarray(ul), impl="pallas_interpret",
                                   row_mask=None if mask is None else jnp.asarray(mask), **kw)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (f, g, w, b)))
    leaves = [t.requires_grad_(True) for t in _t(f, g, w, b)]
    n0 = (J.joint_fused_forward.launches, J.joint_fused_backward.launches)
    loss = rnnt_loss_fused(*leaves, *_t(labels, fl, ul), impl="pallas",
                           row_mask=None if mask is None else torch.from_numpy(mask), **kw)
    grads = torch.autograd.grad(loss, leaves)
    assert (J.joint_fused_forward.launches, J.joint_fused_backward.launches) == n0  # CPU: plain
    np.testing.assert_allclose(float(loss.detach()), float(jv), atol=1e-5)
    for name, got, want in zip(("f", "g", "w", "b"), grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    # the same loss through the chunked joint, and the remat warning
    xla = rnnt_loss_fused(*_t(f, g, w, b, labels, fl, ul), impl="xla",
                          row_mask=None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(float(xla), float(loss.detach()), atol=1e-5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rnnt_loss_fused(*_t(f, g, w, b, labels, fl, ul), impl="pallas", remat="none", **kw)
    assert any("no effect with the pallas" in str(c.message) for c in caught)


def test_rnnt_loss_pallas_draws_its_seed_from_the_host_generator():
    f, g, w, b, _, _, _ = _case(9, T=10, U1=4)
    labels, fl, ul = np.ones((3, 3), np.int32), np.array([10, 8, 3], np.int32), np.array([3, 2, 1])
    args = _t(f, g, w, b, labels, fl, ul)
    kw = dict(blank=10, dropout_rate=0.2, impl="pallas")
    a = rnnt_loss_fused(*args, host_generator=torch.Generator().manual_seed(1), **kw)
    a2 = rnnt_loss_fused(*args, host_generator=torch.Generator().manual_seed(1), **kw)
    c = rnnt_loss_fused(*args, host_generator=torch.Generator().manual_seed(2), **kw)
    seed0 = rnnt_loss_fused(*args, **kw)  # no generator: seed 0, dropout still on
    off = rnnt_loss_fused(*args, blank=10, impl="pallas")
    assert torch.equal(a, a2) and not torch.equal(a, c)
    assert not torch.equal(seed0, off)


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_remat_save_logits_equals_none_and_full(uniform, activation):
    """The three remat policies give the same loss and gradients, with and
    without dropout (the mask drawn once per chunk), and a non-relu
    activation under impl="pallas" takes the chunked path."""
    f, g, w, b, _, _, _ = _case(10, T=11, U1=5)
    if uniform:
        w, b = np.repeat(w[:1], 3, 0), np.repeat(b[:1], 3, 0)
    labels = np.random.default_rng(1).integers(0, 10, (3, 4)).astype(np.int32)
    fl, ul = np.array([11, 7, 2], np.int32), np.array([4, 2, 0], np.int32)
    no_drop = None
    for rate in (0.0, 0.3):
        out = {}
        for remat in ("none", "full", "save_logits"):
            leaves = [t.requires_grad_(True) for t in _t(f, g, w, b)]
            loss = rnnt_loss_fused(*leaves, *_t(labels, fl, ul), blank=10, chunk_size=4,
                                   activation=activation, remat=remat, uniform_head=uniform,
                                   dropout_rate=rate, generator=torch.Generator().manual_seed(5))
            out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
        for remat in ("full", "save_logits"):
            assert torch.equal(out[remat][0], out["none"][0])
            for a, c in zip(out[remat][1], out["none"][1]):
                torch.testing.assert_close(a, c, rtol=0, atol=1e-6)
        no_drop = out["none"][0] if no_drop is None else no_drop
    if activation != "relu":
        got = rnnt_loss_fused(*_t(f, g, w, b, labels, fl, ul), blank=10, chunk_size=4,
                              activation=activation, impl="pallas", uniform_head=uniform)
        torch.testing.assert_close(got, no_drop, rtol=0, atol=1e-6)


def test_remat_save_logits_matches_jax():
    f, g, w, b, _, _, _ = _case(12, T=11, U1=5)
    labels = np.random.default_rng(2).integers(0, 10, (3, 4)).astype(np.int32)
    fl, ul = np.array([11, 7, 2], np.int32), np.array([4, 2, 0], np.int32)
    kw = dict(blank=10, chunk_size=4, remat="save_logits")

    def jloss(*a):
        return jax_rnnt_loss_fused(*a, jnp.asarray(labels), jnp.asarray(fl), jnp.asarray(ul), **kw)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (f, g, w, b)))
    leaves = [t.requires_grad_(True) for t in _t(f, g, w, b)]
    loss = rnnt_loss_fused(*leaves, *_t(labels, fl, ul), **kw)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jv), atol=1e-5)
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_ctc_optax_matches_jax_optax(masked):
    """Loss and gradient of impl="optax" against the JAX package's, with
    an infeasible row (zeroed), a row of adjacent repeats and a padded row;
    and equal to impl="native" where both are defined."""
    rng = np.random.default_rng(13)
    B, T, V1 = 4, 12, 7
    logits = rng.standard_normal((B, T, V1)).astype(np.float32)
    labels = rng.integers(0, V1 - 1, (B, 5)).astype(np.int32)
    labels[1, 1] = labels[1, 0]  # a repeat needs a separating blank
    fl = np.array([12, 9, 3, 12], np.int32)
    ll = np.array([5, 4, 5, 0], np.int32)  # row 2 infeasible, row 3 empty
    mask = np.array([True, True, True, False]) if masked else None
    kw = dict(reduction="mean_batch")

    def jloss(x):
        return jax_ctc_loss(x, jnp.asarray(fl), jnp.asarray(labels), jnp.asarray(ll),
                            impl="optax", row_mask=None if mask is None else jnp.asarray(mask), **kw)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = ctc_loss(x, *_t(fl, labels, ll), impl="optax",
                    row_mask=None if mask is None else torch.from_numpy(mask), **kw)
    (gx,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), float(jv), atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jg), atol=1e-5)
    native = ctc_loss(*_t(logits, fl, labels, ll), reduction="none")
    optax_rows = ctc_loss(*_t(logits, fl, labels, ll), reduction="none", impl="optax")
    np.testing.assert_allclose(optax_rows.numpy(), native.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ctc_loss(*_t(logits, fl, labels, ll), impl="cudnn")


def test_step_config_takes_the_jax_values_and_rejects_others():
    from indic_cl_asr_torch.train.step import StepConfig

    for kw in (dict(rnnt_impl="pallas"), dict(rnnt_remat="save_logits"), dict(ctc_impl="optax"),
               dict(rnnt_remat="none"), dict(rnnt_impl="xla", ctc_impl="native")):
        StepConfig(**kw)
    for kw in (dict(rnnt_impl="cuda"), dict(rnnt_remat="all"), dict(ctc_impl="cudnn")):
        with pytest.raises(ValueError):
            StepConfig(**kw)
