"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so on the machine with the card
it runs without the repository's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Tolerances: flash attention max abs err 1e-4 in f32 and 2e-2 in bf16
(online softmax and f32 sums in another order; bf16 rounds the
probabilities before P·V at a different point); its backward max error
1e-4·max|ref| per gradient in f32 and 2e-2·max|ref| in bf16 (f32 atomics
sum dk, dv and dp in an order that changes from run to run, and the
rounding points of the plain version's autograd differ from the
kernel's); the dropout bits exact; the lattices atol 1e-4 on finite
entries, the NLL to rel 1e-5 and the slab gradients to 1e-5·max|grad|
(both against the plain lattices on the card; the lattice values reach
hundreds, where one f32 step is ~3e-5); the greedy decode token-exact in
f32; a tiny training step on the card against the same step on the CPU
(losses rel 1e-4, gradients 1e-3 of their scale).
"""

import pytest
import torch

from indic_cl_asr_torch.models.hybrid import (
    HybridRNNTCTC,
    flagship_config,
    init_weights_,
    tiny_config,
)
from indic_cl_asr_torch.ops import rnnt_loss as R
from indic_cl_asr_torch.ops.decode_fused import (
    rnnt_greedy_decode_fused,
    rnnt_greedy_decode_fused_reference,
)
from indic_cl_asr_torch.ops.flash_mhsa import (
    dropout_bits,
    flash_dropout_bits_kernel,
    flash_relpos_mhsa,
    flash_relpos_mhsa_backward,
    flash_relpos_mhsa_backward_reference,
    flash_relpos_mhsa_reference,
    keep_threshold,
)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize(
    "B,T,H,D,band",
    [(16, 204, 8, 64, (-1, -1)), (3, 37, 8, 64, (16, 0)), (2, 1, 8, 64, (-1, -1)),
     (2, 512, 8, 64, (-1, -1)), (2, 70, 2, 32, (20, 10)), (2, 65, 4, 16, (-1, 5))],
)
def test_flash_backward_matches_plain_autograd(cuda, dtype, rtol, rate, B, T, H, D, band):
    lens = [T] + [max(0, T - 9 * i) for i in range(1, B - 1)] + ([0] if B > 1 else [])
    args = _flash_inputs(B, T, H, D, lens, dtype, cuda)
    left, right = band
    kw = dict(n_heads=H, left=left, right=right, dropout_rate=rate, seed=T + 7)
    leaves = [a.detach().requires_grad_(True) for a in args[:6]]
    out = flash_relpos_mhsa(*leaves, args[6], **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(T)).to(cuda, dtype)
    before = flash_relpos_mhsa_backward.launches
    got = torch.autograd.grad(out, leaves, dout)
    want = flash_relpos_mhsa_backward_reference(*args, dout, **kw)
    torch.cuda.synchronize()
    assert flash_relpos_mhsa_backward.launches == before + 1
    ref_out = flash_relpos_mhsa_reference(*args, **kw)
    assert (out.float() - ref_out.float()).abs().max().item() <= (1e-4 if dtype == torch.float32 else 2e-2)
    for name, g, w in zip(("q", "k", "v", "p", "bias_u", "bias_v"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        # floor for gradients that vanish in exact arithmetic (T=1: one
        # key per row, so dS = 0 and only rounding residue remains)
        scale = max(w.float().abs().max().item(), 0.01 * dout.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rtol * scale, (name, err, scale)


@pytest.mark.gpu
def test_flash_dropout_bits_match_plain(cuda):
    bits = flash_dropout_bits_kernel(987654321, 3, 8, 61, cuda)
    want = dropout_bits(987654321, 3, 8, 61, cuda)
    assert torch.equal(bits, want)
    keep = (bits <= keep_threshold(0.1)).float().mean().item()
    assert abs(keep - 0.9) < 5e-3


def _lattice_inputs(B, T, U1, t_lens, u_lens, dev):
    g = torch.Generator().manual_seed(B * T + U1)
    lb = -torch.rand((B, T, U1), generator=g) * 3
    ll = -torch.rand((B, T, U1), generator=g) * 3
    tl = torch.tensor(t_lens, dtype=torch.int32)
    ul = torch.tensor(u_lens, dtype=torch.int32)
    return lb.to(dev), ll.to(dev), tl.to(dev), ul.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,T,U1,t_lens,u_lens",
    [(16, 204, 129, [204] * 12 + [1, 150, 100, 204], [128, 0, 64, 1] * 4),
     (3, 7, 4, [7, 5, 3], [3, 2, 1]), (2, 1, 1, [1, 1], [0, 0])],
)
def test_lattice_kernels_match_plain(cuda, B, T, U1, t_lens, u_lens):
    lb, ll, tl, ul = _lattice_inputs(B, T, U1, t_lens, u_lens, cuda)
    lpb, lpl, _, _ = R._prepare(lb, ll, tl, ul)
    a0, b0 = R.rnnt_alpha.launches, R.rnnt_beta.launches
    alpha, beta = R.rnnt_alpha(lpb, lpl), R.rnnt_beta(lpb, lpl, ul)
    alpha_p, beta_p = R._alpha_scan(lpb, lpl), R._beta_scan(lpb, lpl, ul)
    torch.cuda.synchronize()
    assert (R.rnnt_alpha.launches, R.rnnt_beta.launches) == (a0 + 1, b0 + 1)
    for got, want in ((alpha, alpha_p), (beta, beta_p)):
        fin = want > R.NEG_INF / 2
        assert torch.equal(fin, got > R.NEG_INF / 2)
        assert (got[fin] - want[fin]).abs().max().item() <= 1e-4
    x, y = lb.clone().requires_grad_(True), ll.clone().requires_grad_(True)
    nll = R.rnnt_nll_from_logprobs(x, y, tl, ul)
    gx, gy = torch.autograd.grad(nll.sum(), (x, y))
    xp, yp = lb.clone().requires_grad_(True), ll.clone().requires_grad_(True)
    nll_p = R.rnnt_nll_from_logprobs_reference(xp, yp, tl, ul)
    gxp, gyp = torch.autograd.grad(nll_p.sum(), (xp, yp))
    assert ((nll - nll_p).abs() <= 1e-5 * nll_p.abs()).all()
    for g, w in ((gx, gxp), (gy, gyp)):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


def _tiny_step(device, batch_np, seed):
    """One training step of a tiny f32 model (flash attention, dropout on
    the attention probabilities only, SpecAugment on, dither off) on
    ``device``: (aux, grads by name, model)."""
    import dataclasses

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.audio.spec_augment import SpecAugmentConfig
    from indic_cl_asr_torch.train.state import make_optimizer
    from indic_cl_asr_torch.train.step import StepConfig, make_train_step

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, frozen_till=1, dropout_att=0.1, attn_impl="flash"))
    model = init_weights_(HybridRNNTCTC(cfg, device=device), torch.Generator().manual_seed(0))
    opt = make_optimizer(model, lr=1e-3, freeze_encoder_till=1, device=device)
    seen = {}
    apply = opt.step

    def record(grads):
        seen.update(zip(opt.names, (g.detach().cpu() for g in grads)))
        apply(grads)

    opt.step = record
    step_cfg = StepConfig(frontend=FrontendConfig(n_mels=32, dither=0.0),
                          spec_augment=SpecAugmentConfig(freq_masks=1, time_masks=2),
                          rnnt_chunk_size=8)
    step = make_train_step(model, step_cfg, opt, device=device)
    batch = {k: (torch.from_numpy(v).to(device) if hasattr(v, "shape") else v)
             for k, v in batch_np.items()}
    aux = step(batch, torch.Generator().manual_seed(seed))
    return {k: float(v) for k, v in aux.items()}, seen, model


@pytest.mark.gpu
def test_tiny_train_step_on_the_card_matches_the_cpu(cuda):
    """The step through the four training kernels (flash forward with
    dropout, flash backward, alpha, beta) against the same step through the
    plain versions on the CPU: losses rel 1e-4, gradients within
    1e-3·max|grad| per parameter (the key and depthwise conv biases,
    zero in exact arithmetic, within 1e-3 of their weights'), BatchNorm statistics atol 1e-5."""
    import numpy as np

    rng = np.random.default_rng(4)
    B, S, U = 4, 8000, 6
    batch = {"audio": (0.1 * rng.standard_normal((B, S))).astype(np.float32),
             "audio_len": np.array([S, S - 1500, S // 2, S // 4], np.int32),
             "tokens": rng.integers(1, 16, (B, U)).astype(np.int32),
             "token_len": np.array([U, U - 2, U - 1, 3], np.int32),
             "lang_ids": np.array([0, 1, 2, 3], np.int32), "n_valid": 4}
    counts = (flash_relpos_mhsa.launches, flash_relpos_mhsa_backward.launches,
              R.rnnt_alpha.launches, R.rnnt_beta.launches)
    aux_c, grads_c, model_c = _tiny_step(cuda, batch, seed=3)
    torch.cuda.synchronize()
    after = (flash_relpos_mhsa.launches, flash_relpos_mhsa_backward.launches,
             R.rnnt_alpha.launches, R.rnnt_beta.launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (2, 1, 1, 1)
    aux_p, grads_p, model_p = _tiny_step("cpu", batch, seed=3)
    for k in aux_p:
        assert abs(aux_c[k] - aux_p[k]) <= 1e-4 * abs(aux_p[k]), k
    assert grads_c.keys() == grads_p.keys()
    for name, g in grads_p.items():
        # the key bias (a per-row score shift the softmax ignores) and the
        # depthwise conv bias (removed by train-mode BatchNorm) have no
        # gradient in exact arithmetic: their residue is held to their
        # weights' scale
        ref = grads_p[name.replace("linear_k.bias", "linear_k.weight")
                      .replace("depthwise_conv.bias", "depthwise_conv.weight")]
        assert (grads_c[name] - g).abs().max() <= 1e-3 * ref.abs().max(), name
    sd_c, sd_p = model_c.state_dict(), model_p.state_dict()
    for name, t in sd_p.items():
        if name.endswith(("running_mean", "running_var")):
            assert (sd_c[name].cpu() - t).abs().max() <= 1e-5, name
