"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so on the machine with the card
it runs without the repository's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Tolerances: flash attention max abs err 1e-4 in f32 and 2e-2 in bf16
(online softmax and f32 sums in another order; bf16 rounds the
probabilities before P·V at a different point); the greedy decode
token-exact in f32.
"""

import pytest
import torch

from indic_cl_asr_torch.models.hybrid import (
    HybridRNNTCTC,
    flagship_config,
    init_weights_,
    tiny_config,
)
from indic_cl_asr_torch.ops.decode_fused import (
    rnnt_greedy_decode_fused,
    rnnt_greedy_decode_fused_reference,
)
from indic_cl_asr_torch.ops.flash_mhsa import flash_relpos_mhsa, flash_relpos_mhsa_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _flash_inputs(B, T, H, D, lens, dtype, dev):
    g = torch.Generator().manual_seed(B * 1000 + T)
    E = H * D
    q, k = (torch.randn((B, T, E), generator=g) for _ in range(2))
    v = 0.5 * torch.randn((B, T, E), generator=g)
    p = torch.randn((2 * T - 1, E), generator=g)
    u, vb = (0.1 * torch.randn((H, D), generator=g) for _ in range(2))
    ts = [t.to(dev, dtype) for t in (q, k, v, p, u, vb)]
    return ts + [torch.tensor(lens, dtype=torch.int32, device=dev)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "B,T,H,D,band",
    [(16, 204, 8, 64, (-1, -1)), (3, 37, 8, 64, (16, 0)), (2, 1, 8, 64, (-1, -1)),
     (2, 512, 8, 64, (-1, -1)), (2, 70, 2, 32, (20, 10)), (2, 65, 4, 16, (-1, 5)),
     (2, 129, 2, 128, (-1, -1))],
)
def test_flash_kernel_matches_plain(cuda, dtype, atol, B, T, H, D, band):
    lens = [T] + [max(0, T - 9 * i) for i in range(1, B - 1)] + ([0] if B > 1 else [])
    args = _flash_inputs(B, T, H, D, lens, dtype, cuda)
    left, right = band
    before = flash_relpos_mhsa.launches
    out = flash_relpos_mhsa(*args, n_heads=H, left=left, right=right)
    ref = flash_relpos_mhsa_reference(*args, n_heads=H, left=left, right=right)
    torch.cuda.synchronize()
    assert flash_relpos_mhsa.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.gpu
@pytest.mark.parametrize(
    "T,max_symbols,max_out,mixed",
    [(204, 10, 256, False), (300, 10, 256, False), (60, 2, 8, False),
     (204, 10, 256, True)],
)
def test_decode_kernel_token_exact_f32(cuda, T, max_symbols, max_out, mixed):
    """Flagship widths (pred/joint 640, 12 languages x 256 tokens + blank)
    in f32; the mixed case gives each row another language's head."""
    model = HybridRNNTCTC(flagship_config(torch.float32, n_layers=1), device=cuda)
    init_weights_(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(T)
    f_proj = torch.randn((16, T, 640), generator=g).to(cuda)
    lens = torch.randint(1, T + 1, (16,), generator=g)
    lens[1] = 0
    lens = lens.to(cuda)
    lang = (torch.arange(16) % 12 if mixed else torch.full((16,), 3)).to(cuda)
    # heads scaled for margins, and a blank bias at which about a tenth of
    # the frames open with a token, so rows mix blanks and emissions
    with torch.no_grad():
        model.joint.head_kernel.mul_(8.0)
        g0, _ = model.pred_step(torch.full((16,), 256, device=cuda), None)
        logits = torch.einsum(
            "bth,bhv->btv", torch.relu(f_proj + g0[:, None]),
            model.joint.head_kernel[lang],
        )
        margin = logits[..., :-1].amax(-1) - logits[..., -1]
        model.joint.head_bias[:, -1] = torch.quantile(margin.flatten(), 0.9)
    kw = dict(max_symbols=max_symbols, max_out=max_out)
    ids, n = rnnt_greedy_decode_fused(f_proj, lens, lang, model, **kw)
    ids_p, n_p = rnnt_greedy_decode_fused_reference(f_proj, lens, lang, model, **kw)
    torch.cuda.synchronize()
    assert int(n_p.sum()) > 0 and int(n[1]) == 0
    assert torch.equal(n, n_p)
    assert torch.equal(ids, ids_p)


@pytest.mark.gpu
def test_decode_kernel_rejects_what_it_does_not_take(cuda):
    f_proj = torch.zeros((2, 5, 40), device=cuda, dtype=torch.bfloat16)
    lens = torch.full((2,), 5, device=cuda)
    lang = torch.zeros((2,), dtype=torch.int32, device=cuda)
    # bf16 mat-vecs load 8 lanes at a time: a pred width of 36 does not fit
    model = HybridRNNTCTC(
        tiny_config(pred_hidden=36, joint_hidden=40, dtype=torch.bfloat16), device=cuda
    )
    with pytest.raises(ValueError):
        rnnt_greedy_decode_fused(f_proj, lens, lang, model)
    # two LSTM layers
    model = HybridRNNTCTC(tiny_config(pred_rnn_layers=2), device=cuda)
    with pytest.raises(ValueError):
        rnnt_greedy_decode_fused(f_proj.float()[..., :32], lens, lang, model)
    # a joint width whose partial sums overflow one block's shared memory:
    # the card refuses the launch and the wrapper raises its error
    model = HybridRNNTCTC(tiny_config(joint_hidden=65536), device=cuda)
    f_big = torch.zeros((2, 5, 65536), device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rnnt_greedy_decode_fused(f_big, lens, lang, model)
