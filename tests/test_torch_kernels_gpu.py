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
(losses rel 1e-4, gradients 1e-3 of their scale); the fused beam's ids
and lens equal to its plain version's in f32 and scores within 1e-5 of
|score|, except rows where the plain version's trace shows two competing
candidates within 1e-5 of each other.
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
     (2, 129, 2, 128, (-1, -1)),
     # the 64-row tiles' edges, and a CL evaluation batch's shape
     (2, 63, 8, 64, (-1, -1)), (2, 64, 8, 64, (-1, -1)), (2, 128, 8, 64, (-1, -1)),
     (4, 104, 8, 64, (-1, -1))],
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
    "B,T,max_symbols,max_out,mixed",
    [(16, 204, 10, 256, False), (16, 300, 10, 256, False), (16, 60, 2, 8, False),
     (16, 204, 10, 256, True), (1, 204, 10, 256, False), (40, 120, 10, 256, True)],
)
def test_decode_kernel_token_exact_f32(cuda, B, T, max_symbols, max_out, mixed):
    """Flagship widths (pred/joint 640, 12 languages x 256 tokens + blank)
    in f32; the mixed cases give each row another language's head; a batch
    of one row (one cluster) and of 40 rows (more clusters than one wave
    of the card holds). The work counters count each row once, not once
    per block of its cluster: one LSTM step per emitted token plus the
    priming step of each row with frames."""
    from indic_cl_asr_torch.ops import decode_fused as dfm

    model = HybridRNNTCTC(flagship_config(torch.float32, n_layers=1), device=cuda)
    init_weights_(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(T + B)
    f_proj = torch.randn((B, T, 640), generator=g).to(cuda)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    if B > 1:
        lens[1] = 0
    lens = lens.to(cuda)
    lang = (torch.arange(B) % 12 if mixed else torch.full((B,), 3)).to(cuda)
    # heads scaled for margins, and a blank bias at which about a tenth of
    # the frames open with a token, so rows mix blanks and emissions
    with torch.no_grad():
        model.joint.head_kernel.mul_(8.0)
        g0, _ = model.pred_step(torch.full((B,), 256, device=cuda), None)
        logits = torch.einsum(
            "bth,bhv->btv", torch.relu(f_proj + g0[:, None]),
            model.joint.head_kernel[lang],
        )
        margin = logits[..., :-1].amax(-1) - logits[..., -1]
        model.joint.head_bias[:, -1] = torch.quantile(margin.flatten(), 0.9)
    kw = dict(max_symbols=max_symbols, max_out=max_out)
    dfm.reset_counts()
    ids, n = rnnt_greedy_decode_fused(f_proj, lens, lang, model, **kw)
    work = dfm.work_counts()
    ids_p, n_p = rnnt_greedy_decode_fused_reference(f_proj, lens, lang, model, **kw)
    torch.cuda.synchronize()
    assert rnnt_greedy_decode_fused.launches == 1
    assert int(n_p.sum()) > 0 and (B == 1 or int(n[1]) == 0)
    assert torch.equal(n, n_p)
    assert torch.equal(ids, ids_p)
    assert work["lstm_steps"] == int(n.sum()) + int((lens > 0).sum())
    assert work["row_lstm_steps_max"] == int(n.max()) + 1
    assert work["joint_evals"] >= int(lens.sum()) and work["row_joint_evals_max"] >= int(lens.max())


@pytest.mark.gpu
def test_decode_kernel_rejects_what_it_does_not_take(cuda):
    """CUDA tensors launch the kernel or raise, never the plain version."""
    from indic_cl_asr_torch.ops import decode_fused as dfm

    f_proj = torch.zeros((2, 5, 40), device=cuda, dtype=torch.bfloat16)
    lens = torch.full((2,), 5, device=cuda)
    lang = torch.zeros((2,), dtype=torch.int32, device=cuda)
    dfm.reset_counts()
    # bf16 mat-vecs load 8 lanes at a time, and the cluster splits the
    # units in such groups: a pred width of 36 does not fit
    model = HybridRNNTCTC(
        tiny_config(pred_hidden=36, joint_hidden=40, dtype=torch.bfloat16), device=cuda
    )
    with pytest.raises(ValueError):
        rnnt_greedy_decode_fused(f_proj, lens, lang, model)
    # two LSTM layers
    model = HybridRNNTCTC(tiny_config(pred_rnn_layers=2), device=cuda)
    with pytest.raises(ValueError):
        rnnt_greedy_decode_fused(f_proj.float()[..., :32], lens, lang, model)
    # one block's shared memory holds the full g and joint input (two f32
    # vectors of the joint width) beside its own partial sums: a joint
    # width of 16384 fits the 227 KB a block may have, 32768 does not, and
    # the card refuses that launch; the wrapper raises its error
    for width, fits in ((16384, True), (32768, False)):
        model = HybridRNNTCTC(tiny_config(joint_hidden=width), device=cuda)
        f_big = torch.zeros((2, 5, width), device=cuda)
        if fits:
            ids, n = rnnt_greedy_decode_fused(f_big, lens, lang, model)
            ids_p, n_p = rnnt_greedy_decode_fused_reference(f_big, lens, lang, model)
            assert torch.equal(ids, ids_p) and torch.equal(n, n_p)
        else:
            with pytest.raises(RuntimeError, match="CUDA error"):
                rnnt_greedy_decode_fused(f_big, lens, lang, model)
    assert rnnt_greedy_decode_fused.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,D,band", [(16, 204, 8, 64, (-1, -1)), (4, 104, 8, 64, (-1, -1)),
                                          (3, 37, 8, 64, (16, 0))])
def test_flash_kernel_with_dropout_matches_plain_bf16(cuda, B, T, H, D, band):
    """The bf16 forward with dropout 0.1 against the plain version drawing
    the same bits (same seed), at the bf16 bar."""
    lens = [T] + [max(0, T - 9 * i) for i in range(1, B - 1)] + ([0] if B > 1 else [])
    args = _flash_inputs(B, T, H, D, lens, torch.bfloat16, cuda)
    kw = dict(n_heads=H, left=band[0], right=band[1], dropout_rate=0.1, seed=T + 3)
    out = flash_relpos_mhsa(*args, **kw)
    ref = flash_relpos_mhsa_reference(*args, **kw)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert not torch.equal(out, flash_relpos_mhsa(*args, **dict(kw, dropout_rate=0.0)))


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
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("band", [(-1, -1), (16, 0), (-1, 3)])
@pytest.mark.parametrize("T", [1, 37, 63, 64, 65, 129, 204, 512, 576])
def test_flash_backward_mma_bf16_matches_plain_autograd(cuda, T, band, rate):
    """The bf16 backward on the tensor cores (flash_relpos_bwd_mma_kernel)
    at the tile edges, rows of length 0 and 1, bands, with dropout (T 576:
    nine key tiles, past the eight whose keep masks the first walk keeps)."""
    B, H, D = 4, 8, 64
    lens = [T, max(1, T - 13), 1, 0]
    args = _flash_inputs(B, T, H, D, lens, torch.bfloat16, cuda)
    kw = dict(n_heads=H, left=band[0], right=band[1], dropout_rate=rate, seed=T + 5)
    leaves = [a.detach().requires_grad_(True) for a in args[:6]]
    out = flash_relpos_mhsa(*leaves, args[6], **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(T + 1)).to(cuda, torch.bfloat16)
    got = torch.autograd.grad(out, leaves, dout)
    want = flash_relpos_mhsa_backward_reference(*args, dout, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("q", "k", "v", "p", "bias_u", "bias_v"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        scale = max(w.float().abs().max().item(), 0.01 * dout.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * scale, (name, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_backward_mma_rebuilds_the_forwards_scores(cuda, rate):
    """With a (0, 0) band every row sees its own key alone, so the
    forward's lse is that key's score and P = exp(s - lse) is exactly 1
    if the backward rebuilds the forward's scores bit for bit: then
    dS = 0 and dq, dk, dp and the bias gradients are exactly zero in bf16,
    while dv is P·dO."""
    B, T, H, D = 3, 204, 8, 64
    args = _flash_inputs(B, T, H, D, [T, 150, 1], torch.bfloat16, cuda)
    kw = dict(n_heads=H, left=0, right=0, dropout_rate=rate, seed=9)
    leaves = [a.detach().requires_grad_(True) for a in args[:6]]
    out = flash_relpos_mhsa(*leaves, args[6], **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(cuda, torch.bfloat16)
    dq, dk, dv, dp, dbu, dbv = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    for name, g in (("q", dq), ("k", dk), ("p", dp), ("bias_u", dbu), ("bias_v", dbv)):
        assert not g.any(), name
    want = flash_relpos_mhsa_backward_reference(*args, dout, **kw)[2]
    scale = want.float().abs().max().item()
    assert scale > 0 and (dv.float() - want.float()).abs().max().item() <= 2e-2 * scale


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


def _tiny_step(device, batch_np, seed, rnnt_impl="xla"):
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
                          rnnt_chunk_size=8, rnnt_impl=rnnt_impl)
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


def _joint_inputs(B, T, U1, H, V1, dtype, dev, seed=0):
    """f, g (compute dtype), two languages' heads gathered per row (f32),
    labels_pad with an out-of-range label and the pad column 0."""
    g_ = torch.Generator().manual_seed(seed)
    f = (0.5 * torch.randn((B, T, H), generator=g_)).to(dtype)
    g = (0.5 * torch.randn((B, U1, H), generator=g_)).to(dtype)
    heads = torch.randn((2, H, V1), generator=g_) * H ** -0.5 * 4
    hb = 0.1 * torch.randn((2, V1), generator=g_)
    lang = torch.arange(B) % 2
    labels = torch.randint(0, V1 - 1, (B, U1), generator=g_, dtype=torch.int32)
    labels[:, -1] = 0
    labels[0, 0] = V1 + 5
    cots = [torch.randn((B, T, U1), generator=g_) for _ in range(2)]
    for c in cots:
        c[:, T - T // 4:] = 0.0  # frames past a row's length get no cotangent
    to = lambda t: t.to(dev)  # noqa: E731
    return [to(f), to(g), to(heads[lang]), to(hb[lang]), to(labels)], [to(c) for c in cots]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,grad_tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,T,U1,H,V1", [(16, 204, 129, 640, 257), (3, 37, 9, 64, 33),
                                         (2, 5, 3, 640, 257), (2, 70, 130, 96, 300),
                                         (2, 19, 11, 136, 129)])
def test_joint_fused_kernels_match_plain(cuda, dtype, grad_tol, rate, B, T, U1, H, V1):
    """Both slabs atol 1e-5 of the forward evaluated exactly (the plain
    version with an f64 head: the joint input is rounded the same way on
    both sides; the f32 plain version's own sums are up to ~1e-5 off at
    the flagship, so it cannot be the slabs' reference for a kernel that
    sums in another order); dW and db within 1e-5 of
    max|ref| (f32 outputs; the backward's products are split TF32 on the
    tensor cores, as faithful as f32 sums); df and dg within 1e-5 of
    max|ref| in f32 and 1e-2 in bf16, where both sides round their f32
    sums to bf16 once (one bf16 step is 2^-8 of the value) and f32
    atomics sum in another order. The last shape cuts every tile edge of
    the backward: 209 pairs, H 136 and V+1 129 are multiples of none of
    its pair tiles, head tiles, column chunks or dW tiles. A forward under
    ``no_grad`` keeps nothing but its slabs; one that records a graph
    keeps the inputs scratch for the backward."""
    from indic_cl_asr_torch.ops import _build
    from indic_cl_asr_torch.ops import joint_fused as J

    args, (dlpb, dlpl) = _joint_inputs(B, T, U1, H, V1, dtype, cuda, seed=T + U1)
    kw = dict(blank=V1 - 1, dropout_rate=rate)
    leaves = [a.clone().requires_grad_(True) for a in args[:4]]
    scratch = _build.load("joint_fused").joint_fused_scratch(
        B, T, U1, H, V1, int(dtype == torch.bfloat16), 0) * 4
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(cuda)
    with torch.no_grad():
        npb, npl = J.joint_slabs(*leaves, args[4], 1234, **kw)
    torch.cuda.synchronize()
    # the slabs' blocks (the caching allocator may hand out a cached block
    # up to 1 MB larger than asked), not the inputs scratch
    assert torch.cuda.memory_allocated(cuda) - m0 < scratch
    del npb, npl
    assert torch.cuda.memory_allocated(cuda) == m0
    n0 = (J.joint_fused_forward.launches, J.joint_fused_backward.launches)
    lpb, lpl = J.joint_slabs(*leaves, args[4], 1234, **kw)
    assert torch.cuda.memory_allocated(cuda) - m0 >= scratch + lpb.nbytes + lpl.nbytes
    got = torch.autograd.grad((lpb * dlpb + lpl * dlpl).sum(), leaves)
    torch.cuda.synchronize()
    assert (J.joint_fused_forward.launches - n0[0], J.joint_fused_backward.launches - n0[1]) == (1, 1)
    leaves_p = [a.clone().requires_grad_(True) for a in args[:4]]
    rpb, rpl = J.joint_slabs_reference(*leaves_p, args[4], 1234, **kw)
    want = torch.autograd.grad((rpb * dlpb + rpl * dlpl).sum(), leaves_p)
    with torch.no_grad():
        xpb, xpl = J._forward_reference(*args[:2], args[2].double(), args[3].double(), args[4],
                                        1234, V1 - 1, rate)
    assert (lpb - xpb).abs().max().item() <= 1e-5
    assert (lpl - xpl).abs().max().item() <= 1e-5
    for name, a, b, tol in zip(("df", "dg", "dW", "db"), got, want,
                               (grad_tol, grad_tol, 1e-5, 1e-5)):
        assert a.dtype == b.dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item(), (name, err)


@pytest.mark.gpu
def test_joint_dropout_bits_match_plain(cuda):
    from indic_cl_asr_torch.ops import joint_fused as J

    bits = J.joint_dropout_bits_kernel(987654321, 3, 41, 17, 640, cuda)
    want = J.dropout_bits(987654321, 3, 17, 640, 0, 41, cuda)
    assert torch.equal(bits, want)
    keep = (bits <= keep_threshold(0.2)).double().mean().item()
    assert abs(keep - 0.8) < 2e-3


@pytest.mark.gpu
def test_joint_kernels_reject_what_they_do_not_take(cuda):
    from indic_cl_asr_torch.ops import _build
    from indic_cl_asr_torch.ops import joint_fused as J

    args, _ = _joint_inputs(2, 5, 3, 2048, 9, torch.float32, cuda)
    with pytest.raises(ValueError):  # H=2048 in f32 overflows shared memory
        J.joint_slabs(*args, 0, blank=8)
    # the forward and the backward share their limit: a tile of 128 pairs'
    # joint input beside the head ring fits at the flagship's H640 V+1 257
    # in bf16 and not at H768
    lib = _build.load("joint_fused")
    for backward in (0, 1):
        assert (lib.joint_fused_smem(640, 257, 1, backward) <= J._SMEM_MAX
                < lib.joint_fused_smem(768, 9, 1, backward))
    args, (dlpb, dlpl) = _joint_inputs(2, 5, 3, 768, 9, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        J.joint_slabs(*args, 0, blank=8)
    with pytest.raises(ValueError):
        J.joint_fused_forward(*args, 0, blank=8, dropout_rate=0.0)
    lse = torch.zeros((2, 5, 3), device=cuda)
    with pytest.raises(ValueError):
        J.joint_fused_backward(*args, 0, lse, dlpb, dlpl, blank=8, dropout_rate=0.0)
    # a scratch of other shapes than the call's
    args, (dlpb, dlpl) = _joint_inputs(2, 5, 3, 64, 9, torch.float32, cuda)
    with pytest.raises(ValueError):
        J.joint_fused_backward(*args, 0, lse, dlpb, dlpl, blank=8, dropout_rate=0.0,
                               inputs=torch.zeros(7, device=cuda))
    args, _ = _joint_inputs(2, 5, 3, 16, 9, torch.float16, cuda)
    with pytest.raises(TypeError):
        J.joint_slabs(*args, 0, blank=8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_joint_backward_on_the_forward_scratch_equals_its_own(cuda, dtype):
    """The backward on the forward's inputs scratch (the training path) and
    on one it forms itself with the same kernels, at a shape that cuts
    every tile edge, dropout 0.2: dW and db equal bit for bit; df and dg
    come from f32 atomics whose order varies from run to run, so they
    agree to 1e-6 of max|ref| in f32 and one bf16 step (2^-8) in bf16."""
    from indic_cl_asr_torch.ops import joint_fused as J

    args, (dlpb, dlpl) = _joint_inputs(2, 19, 11, 136, 129, dtype, cuda, seed=3)
    kw = dict(blank=128, dropout_rate=0.2)
    _, _, lse, inputs = J.joint_fused_forward(*args, 1234, **kw)
    n0 = J.joint_fused_backward.launches
    on_fwd = J.joint_fused_backward(*args, 1234, lse, dlpb, dlpl, inputs=inputs, **kw)
    own = J.joint_fused_backward(*args, 1234, lse, dlpb, dlpl, **kw)
    torch.cuda.synchronize()
    assert J.joint_fused_backward.launches - n0 == 2
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    for name, a, b in zip(("df", "dg", "dW", "db"), on_fwd, own):
        assert a.dtype == b.dtype
        if name in ("dW", "db"):
            assert torch.equal(a, b), name
        else:
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * b.float().abs().max().item(), (name, err)


@pytest.mark.gpu
def test_tiny_pallas_train_step_on_the_card_matches_the_cpu(cuda):
    """The step with ``rnnt_impl="pallas"``: the joint kernels on the card
    against their plain versions on the CPU, at the bars of the xla step."""
    import numpy as np

    from indic_cl_asr_torch.ops import joint_fused as J

    rng = np.random.default_rng(5)
    B, S, U = 4, 8000, 6
    batch = {"audio": (0.1 * rng.standard_normal((B, S))).astype(np.float32),
             "audio_len": np.array([S, S - 1500, S // 2, S // 4], np.int32),
             "tokens": rng.integers(1, 16, (B, U)).astype(np.int32),
             "token_len": np.array([U, U - 2, U - 1, 3], np.int32),
             "lang_ids": np.array([0, 1, 2, 3], np.int32), "n_valid": 3}
    n0 = (J.joint_fused_forward.launches, J.joint_fused_backward.launches)
    aux_c, grads_c, _ = _tiny_step(cuda, batch, seed=3, rnnt_impl="pallas")
    torch.cuda.synchronize()
    assert (J.joint_fused_forward.launches - n0[0], J.joint_fused_backward.launches - n0[1]) == (1, 1)
    aux_p, grads_p, _ = _tiny_step("cpu", batch, seed=3, rnnt_impl="pallas")
    for k in aux_p:
        assert abs(aux_c[k] - aux_p[k]) <= 1e-4 * abs(aux_p[k]), k
    for name, g in grads_p.items():
        ref = grads_p[name.replace("linear_k.bias", "linear_k.weight")
                      .replace("depthwise_conv.bias", "depthwise_conv.weight")]
        assert (grads_c[name] - g).abs().max() <= 1e-3 * ref.abs().max(), name


@pytest.mark.gpu
def test_mas_importance_batch_on_the_card_matches_the_cpu(cuda):
    """MAS's surrogate runs the prediction net in eval mode and takes its
    gradient (cuDNN's LSTM backward must be asked for in its forward): the
    importance of one batch on the card against the CPU's, within 1e-3 of
    max|Omega| per parameter, the BatchNorm statistics untouched."""
    import numpy as np

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.cl import mas as M
    from indic_cl_asr_torch.cl.methods import MASMethod
    from indic_cl_asr_torch.train.state import make_optimizer
    from indic_cl_asr_torch.train.step import StepConfig

    rng = np.random.default_rng(6)
    B, S, U = 3, 8000, 5
    batch_np = {"audio": (0.1 * rng.standard_normal((B, S))).astype(np.float32),
                "audio_len": np.array([S, S - 1500, S // 2], np.int32),
                "tokens": rng.integers(1, 16, (B, U)).astype(np.int32),
                "token_len": np.array([U, U - 2, 3], np.int32),
                "lang_ids": np.array([1, 1, 1], np.int32), "n_valid": 2}
    omega = {}
    for dev in (cuda, torch.device("cpu")):
        model = init_weights_(HybridRNNTCTC(tiny_config(), device=dev),
                              torch.Generator().manual_seed(0))
        opt = make_optimizer(model, lr=1e-3, freeze_encoder_till=1, device=dev)
        step_cfg = StepConfig(frontend=FrontendConfig(n_mels=32, dither=0.0),
                              rnnt_chunk_size=8, uniform_lang_head=True)
        method = MASMethod(M.MASConfig(mas_ctx=0.3), model, step_cfg, opt)
        stats = {n: b.clone() for n, b in model.named_buffers()}
        batch = {k: (torch.from_numpy(v).to(dev) if hasattr(v, "shape") else v)
                 for k, v in batch_np.items()}
        acc = method.importance_batch(method.begin_importance(), batch,
                                      torch.Generator().manual_seed(1))
        assert all(torch.equal(b, stats[n]) for n, b in model.named_buffers())
        omega[dev.type] = {n: v.cpu() for n, v in acc.items()}
    assert omega["cuda"].keys() == omega["cpu"].keys()
    for n, want in omega["cpu"].items():
        # the key and depthwise conv biases have no gradient in exact
        # arithmetic: their residue is held to their weights' scale
        ref = omega["cpu"][n.replace("linear_k.bias", "linear_k.weight")
                          .replace("depthwise_conv.bias", "depthwise_conv.weight")]
        assert (omega["cuda"][n] - want).abs().max() <= 1e-3 * ref.abs().max(), n


def _beam_model(cfg, dev, lang, f_proj, q=0.97):
    """Seeded weights, heads scaled for margins, and the blank bias of each
    language set so a fraction 1-q of the frames open with a token."""
    model = init_weights_(HybridRNNTCTC(cfg, device=dev), torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.joint.head_kernel.mul_(8.0)
        B = f_proj.shape[0]
        g0, _ = model.pred_step(torch.full((B,), model.cfg.blank_local, device=dev), None)
        logits = torch.einsum("bth,bhv->btv", torch.relu(f_proj + g0[:, None]),
                              model.joint.head_kernel[lang.long()])
        margin = logits[..., :-1].amax(-1) - logits[..., -1]
        model.joint.head_bias[:, -1] = torch.quantile(margin.flatten().float(), q)
    return model


def _beam_agrees(got, want, trace):
    """ids and lens equal row by row and scores within 1e-5 of |score|; a
    row that differs only where the plain version's trace shows two
    competing candidates within 1e-5 of each other (the kernel sums in
    another order than cuBLAS). Returns the number of such rows."""
    (ids, n, sc), (ids_p, n_p, sc_p) = got, want
    same = (ids == ids_p).all(dim=1) & (n == n_p)
    gap = torch.stack(trace).amin(dim=0)
    assert bool((gap[~same] <= 1e-5).all()), (same, gap)
    err = (sc - sc_p).abs()[same] / sc_p.abs()[same].clamp(min=1.0)
    assert err.numel() == 0 or float(err.max()) <= 1e-5
    return int((~same).sum())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "width,T,beam,max_out,mixed",
    [("tiny", 40, 4, 64, True), ("tiny", 40, 1, 64, False), ("tiny", 40, 3, 6, False),
     ("flagship", 204, 4, 256, False), ("flagship", 204, 4, 256, True),
     ("flagship", 120, 4, 12, False)],
)
def test_beam_kernel_matches_plain_f32(cuda, width, T, beam, max_out, mixed):
    """The fused beam against the batched beam over the model's own steps
    in f32, at a small and at the flagship width (pred/joint 640, 12
    languages x 256 tokens + blank), with a zero-length row, unequal
    lengths, mixed languages, beam 1 and a max_out that caps rows."""
    from indic_cl_asr_torch.ops import beam_fused as bfm

    cfg = (tiny_config(dtype=torch.float32) if width == "tiny"
           else flagship_config(torch.float32, n_layers=1))
    B, H = 16, cfg.joint_hidden
    g = torch.Generator().manual_seed(T + beam)
    f_proj = torch.randn((B, T, H), generator=g).to(cuda)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[1] = 0
    lens = lens.to(cuda)
    lang = (torch.arange(B) % cfg.n_langs if mixed else torch.full((B,), 1)).to(cuda)
    model = _beam_model(cfg, cuda, lang, f_proj)
    kw = dict(beam_size=beam, max_expansions=6, max_out=max_out)
    n0 = bfm.rnnt_beam_search_fused.launches
    with torch.inference_mode():
        got = bfm.rnnt_beam_search_fused(f_proj, lens, lang, model, **kw)
        trace = []
        want = bfm.rnnt_beam_search_fused_reference(f_proj, lens, lang, model, trace=trace, **kw)
    torch.cuda.synchronize()
    assert bfm.rnnt_beam_search_fused.launches == n0 + 1
    assert int(want[1].sum()) > 0 and int(got[1][1]) == 0
    if max_out < 64:
        assert int((want[1] == max_out).sum()) > 0
    assert _beam_agrees(got, want, trace) <= 2


@pytest.mark.gpu
def test_beam_kernel_rejects_what_it_does_not_take(cuda):
    """CUDA tensors launch the kernel or raise, never the plain version."""
    from indic_cl_asr_torch.ops import beam_fused as bfm

    model = HybridRNNTCTC(flagship_config(torch.bfloat16, n_layers=1), device=cuda)
    f_proj = torch.zeros((2, 5, 640), device=cuda, dtype=torch.bfloat16)
    lens = torch.full((2,), 5, device=cuda)
    lang = torch.zeros((2,), dtype=torch.int32, device=cuda)
    n0 = bfm.rnnt_beam_search_fused.launches
    # eight hypotheses at flagship widths overflow one block's shared memory:
    # the card refuses the launch and the wrapper raises its error
    with pytest.raises(RuntimeError, match="CUDA error"):
        bfm.rnnt_beam_search_fused(f_proj, lens, lang, model, beam_size=8)
    with pytest.raises(ValueError):
        bfm.rnnt_beam_search_fused(f_proj, lens, lang, model, beam_size=9)
    with pytest.raises(ValueError):  # two LSTM layers
        bfm.rnnt_beam_search_fused(f_proj.float()[..., :32], lens, lang,
                                   HybridRNNTCTC(tiny_config(pred_rnn_layers=2), device=cuda))
    assert bfm.rnnt_beam_search_fused.launches == n0
    bfm.reset_counts()
    bfm.rnnt_beam_search_fused(f_proj, lens, lang, model, beam_size=2)
    assert bfm.rnnt_beam_search_fused.launches == 1
    work = bfm.work_counts()
    assert work["rounds"] > 0 and work["joint_evals"] >= work["rounds"]
