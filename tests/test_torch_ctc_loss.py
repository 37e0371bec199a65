"""Port parity of the CTC loss: ``indic_cl_asr_torch.ops.ctc_loss`` against
the JAX package's ``ctc_loss(impl="native")`` in f32 on the CPU, values
and gradients with respect to the input log-probs, atol 1e-5. Blank is the
last column; one row is infeasible (fewer frames than labels plus adjacent
repeats) and contributes 0; a row mask leaves a repeat row out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from indic_cl_asr_torch.ops.ctc_loss import ctc_loss


def _case():
    rng = np.random.default_rng(5)
    B, T, V1, U = 4, 9, 6, 4
    logits = rng.standard_normal((B, T, V1)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = np.array([[1, 2, 2, 3], [0, 1, 0, 0], [4, 4, 4, 4], [2, 3, 1, 0]], np.int32)
    frame_lens = np.array([9, 7, 5, 8], np.int32)
    # row 2: 4 labels with 3 adjacent repeats need 7 frames, it has 5
    label_lens = np.array([4, 2, 4, 3], np.int32)
    return lp, frame_lens, labels, label_lens


@pytest.mark.parametrize("reduction", ["mean_batch", "sum", "mean", "none"])
@pytest.mark.parametrize("masked", [False, True])
def test_ctc_matches_jax_native(reduction, masked):
    lp, fl, labels, ll = _case()
    mask = np.array([True, True, True, False]) if masked else None

    def jloss(x):
        out = jax_ctc_loss(x, jnp.asarray(fl), jnp.asarray(labels), jnp.asarray(ll),
                           reduction=reduction, impl="native",
                           row_mask=None if mask is None else jnp.asarray(mask))
        return out, jnp.sum(out * jnp.arange(1.0, 1.0 + out.size).reshape(out.shape))

    jv, jg = jax.jit(lambda x: (jloss(x)[0], jax.grad(lambda y: jloss(y)[1])(x)))(
        jnp.asarray(lp))
    x = torch.from_numpy(lp.copy()).requires_grad_(True)
    out = ctc_loss(x, *(torch.from_numpy(a) for a in (fl, labels, ll)), reduction=reduction,
                   row_mask=None if mask is None else torch.from_numpy(mask))
    weights = torch.arange(1.0, 1.0 + out.numel()).reshape(out.shape)
    (g,) = torch.autograd.grad((out * weights).sum(), x)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
    if reduction == "none":
        nll = out.detach()
        assert float(nll[2]) == 0.0 and float(nll[0]) > 0.0  # infeasible row
        assert torch.all(g[2] == 0)
