"""Plain PyTorch reference of the hybrid RNNT+CTC Conformer: front end,
SpecAugment, encoder, prediction net, joint, RNNT and CTC losses, AdamW and
the greedy decoders, written from the published descriptions (NeMo's
Conformer-Transducer with Transformer-XL relative positions, the RNNT
lattice, optax's AdamW) as plain tensor operations.

Products run in float32 with TF32 off, or, for the control, on operands
rounded to float8 (e4m3 forward, e5m2 gradients, one scale a tensor).

A training step makes the random draws of the CL step in its order, from
the step's CPU generator: a device generator seeded from one draw of it;
on that, the dither, then the 8-bit dropout masks (keep where a byte is
below round((1 - rate)·256)) of the pre-encoder, of each layer's FFN
inner activations and residual branches, of the prediction net's output
and of every 64-frame chunk of the joint input; on the CPU generator the
SpecAugment bands and one 31-bit seed a layer for the attention dropout,
whose bits are a murmur3 hash of (seed, row, head, query, key). The same
generator state gives the same masks on the same kind of device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

NEG = -1e30


class _RoundFP8(torch.autograd.Function):
    """Rounds a tensor to float8 e4m3 (one scale a tensor) going forward
    and its gradient to e5m2 coming back."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(x, dtype, top):
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class Precision:
    """What the products see: ``"f32"`` the operands as they are,
    ``"fp8"`` rounded (the control)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def __call__(self, x):
        return x if self.kind == "f32" else _RoundFP8.apply(x)


class Draws:
    """The random draws of one training step (module docstring)."""

    def __init__(self, host: torch.Generator, device):
        self.host = host
        draw = int(torch.randint(0, 2**62, (1,), generator=host))
        self.dev = torch.Generator(device=torch.device(device))
        self.dev.manual_seed(draw)
        self.device = device

    def keep(self, shape, rate: float):
        t = int(round((1.0 - rate) * 256.0))
        if rate <= 0.0 or t >= 256:
            return None
        bits = torch.randint(0, 256, tuple(shape), generator=self.dev,
                             device=self.device, dtype=torch.uint8)
        return bits < t

    def seed31(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))


def dropout(x, rate, draws):
    if draws is None or rate <= 0.0:
        return x
    keep = draws.keep(x.shape, rate)
    return x if keep is None else torch.where(keep, x / (1.0 - rate), 0.0)


# ---- attention dropout bits: murmur3's finaliser over (seed, b, h, t, j)

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def attention_keep(seed: int, B: int, H: int, T: int, rate: float, device):
    bh = torch.arange(B * H, dtype=torch.int64, device=device).view(B, H)
    key = _fmix32((seed & _M32) ^ _mul32(bh, 0x9E3779B9))
    tj = torch.arange(T * T, dtype=torch.int64, device=device).view(T, T)
    bits = _fmix32(key[:, :, None, None] ^ _fmix32(tj)[None, None])
    return bits <= int((1.0 - rate) * (2**32 - 1))


# ---- front end (NeMo's FilterbankFeatures: preemphasis, STFT, slaney mel,
# log, per-feature normalisation)

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                    f * 3.0 / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * 200.0 / 3.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa's slaney mel filterbank with area normalisation."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    ramps = hz[:, None] - freqs[None, :]
    fdiff = np.diff(hz)
    fb = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    fb *= (2.0 / (hz[2:] - hz[:-2]))[:, None]
    return fb.astype(np.float32)


def frontend(audio, lens, fc: dict, draws=None):
    """[B, S] f32 audio, [B] sample counts -> ([B, n_mels, T] log-mel, [B]
    frame counts); with ``draws`` the training dither."""
    x = audio.float()
    n = lens.long() // fc["hop_length"] + 1
    if draws is not None and fc["dither"] > 0:
        x = x + fc["dither"] * torch.randn(x.shape, generator=draws.dev, device=x.device)
    x = torch.cat([x[:, :1], x[:, 1:] - fc["preemph"] * x[:, :-1]], dim=1)
    nfft, win = fc["n_fft"], fc["win_length"]
    x = F.pad(x[:, None], (nfft // 2, nfft // 2), mode="reflect")[:, 0]
    w = torch.zeros(nfft, device=x.device)
    i = torch.arange(win, device=x.device, dtype=torch.float64)
    left = (nfft - win) // 2
    w[left:left + win] = (0.5 - 0.5 * torch.cos(2 * math.pi * i / (win - 1))).float()
    spec = torch.fft.rfft(x.unfold(1, nfft, fc["hop_length"]) * w, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    fb = torch.from_numpy(mel_filterbank(fc["sample_rate"], nfft, fc["n_mels"])).to(x.device)
    mel = torch.log(torch.einsum("mf,bft->bmt", fb, power) + 2.0 ** -24)
    T = mel.shape[-1]
    valid = (torch.arange(T, device=x.device)[None] < n[:, None])[:, None]
    cnt = n.float().clamp(min=1)[:, None, None]
    mean = torch.where(valid, mel, 0.0).sum(-1, keepdim=True) / cnt
    var = torch.where(valid, (mel - mean) ** 2, 0.0).sum(-1, keepdim=True) / (cnt - 1).clamp(min=1)
    mel = torch.where(valid, (mel - mean) / (var.sqrt() + 1e-5), 0.0)
    pad = (-T) % fc["pad_to"]
    return F.pad(mel, (0, pad)), n


def spec_augment(mel, mel_lens, sa: dict, host: torch.Generator):
    """SpecAugment bands drawn on the CPU generator (NeMo's widths: starts
    and widths uniform over inclusive integer ranges; the time widths
    adaptive), then set to 0."""
    B, Fq, T = mel.shape
    lens = mel_lens.cpu().long()

    def upto(hi, m):
        u = torch.rand((B, m), generator=host, dtype=torch.float64)
        return torch.minimum((u * (hi[:, None] + 1).double()).long(), hi[:, None])

    fw = sa["freq_width"]
    f_start = upto(torch.full((B,), max(Fq - fw, 0)), sa["freq_masks"])
    f_width = upto(torch.full((B,), fw), sa["freq_masks"])
    w_max = (lens.float() * sa["time_width"]).long().clamp(min=1)
    t_start = upto((lens - w_max).clamp(min=1), sa["time_masks"])
    t_width = upto(w_max, sa["time_masks"])

    def band(s, w, size):
        iota = torch.arange(size, device=mel.device)[None, None]
        s, w = s.to(mel.device)[:, :, None], w.to(mel.device)[:, :, None]
        return ((iota >= s) & (iota < s + w)).any(1)

    mel = torch.where(band(f_start, f_width, Fq)[:, :, None], 0.0, mel)
    return torch.where(band(t_start, t_width, T)[:, None, :], 0.0, mel)


# ---- the model, a function of a dict of named tensors

class Reference:
    """The hybrid RNNT+CTC Conformer over ``params`` (the layout of
    layout.py) and the configuration's ``model`` section ``m``."""

    def __init__(self, m: dict, params: dict, prec: Precision | None = None):
        self.m, self.P, self.q = m, params, prec or Precision()
        self.V = m["vocab_size_total"] // m["n_langs"]

    def linear(self, x, name, bias=True):
        y = torch.matmul(self.q(x), self.q(self.P[f"{name}.weight"]).t())
        return y + self.P[f"{name}.bias"] if bias else y

    def layer_norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.P[f"{name}.weight"], self.P[f"{name}.bias"], 1e-6)

    # encoder
    def subsample(self, mel):
        m = self.m
        h = mel.transpose(1, 2)[:, None]
        for i in range(int(math.log2(m["subsampling_factor"]))):
            p = f"encoder.pre_encode.convs.{i}"
            h = F.relu(F.conv2d(self.q(h), self.q(self.P[f"{p}.weight"]), self.P[f"{p}.bias"],
                                stride=2, padding=1))
        B, C, T, Fq = h.shape
        return self.linear(h.permute(0, 2, 3, 1).reshape(B, T, Fq * C), "encoder.pre_encode.out")

    @staticmethod
    def positions(T: int, d: int, device):
        pos = (T - 1) - torch.arange(2 * T - 1, dtype=torch.float32, device=device)
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                        * (-math.log(10000.0) / d))
        ang = pos[:, None] * div[None]
        return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(2 * T - 1, d)

    def attention(self, x, pos, lens, p, draws):
        m = self.m
        B, T, E = x.shape
        H = m["n_heads"]
        D = E // H
        q = self.linear(x, f"{p}.linear_q")
        k = self.linear(x, f"{p}.linear_k").view(B, T, H, D)
        v = self.linear(x, f"{p}.linear_v").view(B, T, H, D)
        pp = self.linear(pos, f"{p}.linear_pos", bias=False).view(-1, H, D)
        qu = (q + self.P[f"{p}.pos_bias_u"].reshape(-1)).view(B, T, H, D)
        qv = (q + self.P[f"{p}.pos_bias_v"].reshape(-1)).view(B, T, H, D)
        ac = torch.einsum("bthd,bshd->bhts", self.q(qu), self.q(k))
        raw = torch.einsum("bthd,phd->bhtp", self.q(qv), self.q(pp))
        t = torch.arange(T, device=x.device)
        shift = (T - 1) + t[None, :] - t[:, None]  # distance j - t
        bd = torch.gather(raw, 3, shift.expand(B, H, T, T))
        s = (ac + bd) / math.sqrt(D)
        valid = t[None] < lens[:, None]
        mask = (valid[:, :, None] & valid[:, None, :])[:, None]
        s = torch.where(mask, s, NEG)
        e = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        den = e.sum(-1, keepdim=True)
        probs = e / torch.where(den == 0, 1.0, den)
        rate = m["dropout_att"]
        if draws is not None and rate > 0:
            keep = attention_keep(draws.seed31(), B, H, T, rate, x.device)
            probs = torch.where(keep, probs / (1.0 - rate), 0.0)
        out = torch.einsum("bhts,bshd->bthd", self.q(probs), self.q(v)).reshape(B, T, E)
        return self.linear(out, f"{p}.linear_out")

    def batch_norm(self, x, p, train):
        if train:
            n = x.shape[0] * x.shape[2]
            mean = x.sum((0, 2)) / n
            var = ((x * x).sum((0, 2)) / n - mean * mean).clamp(min=0.0)
        else:
            mean, var = self.P[f"{p}.running_mean"], self.P[f"{p}.running_var"]
        mul = torch.rsqrt(var + 1e-5) * self.P[f"{p}.weight"]
        return (x - mean[:, None]) * mul[:, None] + self.P[f"{p}.bias"][:, None]

    def conv_module(self, x, pad_mask, p, train):
        a, b = self.linear(x, f"{p}.pointwise_conv1").chunk(2, dim=-1)
        h = torch.where(pad_mask[:, :, None], a * torch.sigmoid(b), 0.0).transpose(1, 2)
        k = self.m["conv_kernel_size"]
        h = F.conv1d(self.q(h), self.q(self.P[f"{p}.depthwise_conv.weight"]),
                     self.P[f"{p}.depthwise_conv.bias"], padding=k // 2, groups=h.shape[1])
        h = F.silu(self.batch_norm(h, f"{p}.batch_norm", train)).transpose(1, 2)
        return self.linear(h, f"{p}.pointwise_conv2")

    def ffn(self, x, p, draws):
        h = dropout(F.silu(self.linear(x, f"{p}.linear1")), self.m["dropout"], draws)
        return self.linear(h, f"{p}.linear2")

    def layer(self, x, pos, lens, pad_mask, i, draws):
        p, r = f"encoder.layers.{i}", self.m["dropout"]
        train = draws is not None
        x = x + 0.5 * dropout(self.ffn(self.layer_norm(x, f"{p}.norm_feed_forward1"),
                                       f"{p}.feed_forward1", draws), r, draws)
        x = x + dropout(self.attention(self.layer_norm(x, f"{p}.norm_self_att"), pos, lens,
                                       f"{p}.self_attn", draws), r, draws)
        x = x + dropout(self.conv_module(self.layer_norm(x, f"{p}.norm_conv"), pad_mask,
                                         f"{p}.conv", train), r, draws)
        x = x + 0.5 * dropout(self.ffn(self.layer_norm(x, f"{p}.norm_feed_forward2"),
                                       f"{p}.feed_forward2", draws), r, draws)
        return self.layer_norm(x, f"{p}.norm_out")

    def encode(self, mel, mel_lens, draws=None, frozen_till: int = 0):
        """Log-mel -> ([B, T, d] encoder output, [B] frames); the
        pre-encoder and layers below ``frozen_till`` build no graph."""
        m = self.m
        lens = mel_lens.long()
        for _ in range(int(math.log2(m["subsampling_factor"]))):
            lens = (lens + 2 - 3) // 2 + 1
        with torch.no_grad() if frozen_till > 0 else torch.enable_grad():
            x = self.subsample(mel)
            if m["xscale"]:
                x = x * math.sqrt(m["d_model"])
            x = dropout(x, m["dropout_pre_encoder"], draws)
        T = x.shape[1]
        pos = self.positions(T, m["d_model"], x.device)
        pad_mask = torch.arange(T, device=x.device)[None] < lens[:, None]
        for i in range(m["n_layers"]):
            with torch.no_grad() if i < frozen_till else torch.enable_grad():
                x = self.layer(x, pos, lens, pad_mask, i, draws)
        return torch.where(pad_mask[:, :, None], x, 0.0), lens

    # prediction net and joint
    def lstm_step(self, x, h, c, n):
        p = f"prediction.lstm.{n}"
        gates = (torch.matmul(self.q(x), self.q(self.P[f"{p}.w_ih"]))
                 + torch.matmul(self.q(h), self.q(self.P[f"{p}.w_hh"])) + self.P[f"{p}.bias"])
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def embed(self, tokens):
        Vt = self.m["vocab_size_total"]
        tokens = tokens.long()
        e = self.P["prediction.embedding"][tokens.clamp(0, Vt)]
        return torch.where((tokens == Vt)[..., None], 0.0, e)

    def predict(self, tokens, draws=None):
        """[B, U] local ids -> [B, U+1, Hp] (a blank SOS in front)."""
        B = tokens.shape[0]
        Vt, Hp = self.m["vocab_size_total"], self.m["pred_hidden"]
        tokens = torch.cat([torch.full((B, 1), Vt, dtype=torch.long, device=tokens.device),
                            tokens.long()], 1)
        h_seq = self.embed(tokens)
        for n in range(self.m["pred_rnn_layers"]):
            h = c = torch.zeros(B, Hp, device=tokens.device)
            outs = []
            for u in range(h_seq.shape[1]):
                h, c = self.lstm_step(h_seq[:, u], h, c, n)
                outs.append(h)
            h_seq = torch.stack(outs, 1)
        return dropout(h_seq, self.m["pred_dropout"], draws)

    def head(self, lang: int):
        return self.P["joint.head_kernel"][lang], self.P["joint.head_bias"][lang]

    def joint_logits(self, f_proj, g_proj, lang: int, keep=None):
        """[B, Tc, Hj] x [B, U1, Hj] -> [B, Tc, U1, V+1] f32 logits."""
        x = F.relu(f_proj[:, :, None] + g_proj[:, None])
        if keep is not None:
            r = self.m["joint_dropout"]
            x = torch.where(keep, x / (1.0 - r), 0.0)
        w, b = self.head(lang)
        return torch.matmul(self.q(x), self.q(w)) + b

    def ctc_logprobs(self, f, lang_ids):
        V, Vt = self.V, self.m["vocab_size_total"]
        K, b = self.P["ctc_decoder.kernel"], self.P["ctc_decoder.bias"]
        cols = torch.stack([torch.cat([torch.arange(l * V, (l + 1) * V), torch.tensor([Vt])])
                            for l in lang_ids.tolist()]).to(f.device)  # [B, V+1]
        w = K[:, cols].permute(1, 0, 2)  # [B, d, V+1]
        logits = torch.matmul(self.q(f), self.q(w)) + b[cols][:, None]
        return torch.log_softmax(logits, -1)


# ---- losses

def rnnt_nll(lp_blank, lp_label, t_lens, u_lens):
    """Per-row -log P(y | x) from the blank and label log-prob slabs
    [B, T, U+1], by the forward recursion over anti-diagonals."""
    B, T, U1 = lp_blank.shape
    D = T + U1 - 1
    dev = lp_blank.device
    d = torch.arange(D, device=dev)[:, None]
    u = torch.arange(U1, device=dev)[None]
    t = d - u
    ok = (t >= 0) & (t < T)
    idx = t.clamp(0, T - 1)
    diag_b = torch.where(ok, lp_blank[:, idx, u.expand(D, U1)], NEG)
    diag_l = torch.where(ok, lp_label[:, idx, u.expand(D, U1)], NEG)
    alpha = torch.full((B, U1), NEG, device=dev)
    alpha = torch.cat([torch.zeros(B, 1, device=dev), alpha[:, 1:]], 1)
    diags = [alpha]
    neg = torch.full((B, 1), NEG, device=dev)
    for k in range(1, D):
        label = torch.cat([neg, (alpha + diag_l[:, k - 1])[:, :-1]], 1)
        alpha = torch.logaddexp(alpha + diag_b[:, k - 1], label)
        diags.append(alpha)
    alphas = torch.stack(diags, 1)  # [B, D, U1]
    rows = torch.arange(B, device=dev)
    tl, ul = t_lens.long(), u_lens.long()
    return -(alphas[rows, tl - 1 + ul, ul] + lp_blank[rows, tl - 1, ul])


def rnnt_loss(ref: Reference, f_proj, g_proj, labels, t_lens, u_lens, lang: int, draws,
              chunk: int):
    """Mean over rows of the RNNT NLL, the joint taken in ``chunk``-frame
    pieces (each recomputed in the backward), a dropout mask a piece."""
    B, T, _ = f_proj.shape
    m = ref.m
    U1 = g_proj.shape[1]
    n = -(-T // chunk)
    f_proj = F.pad(f_proj, (0, 0, 0, n * chunk - T))
    labels_pad = F.pad(labels.long(), (0, 1))
    blank = ref.V

    def piece(fc, gp, keep):
        logits = ref.joint_logits(fc, gp, lang, keep)
        lse = torch.logsumexp(logits, -1)
        lab = torch.gather(logits, 3, labels_pad[:, None, :, None].expand(B, fc.shape[1], U1, 1))[..., 0]
        return logits[..., blank] - lse, lab - lse

    pb, pl = [], []
    for i in range(n):
        keep = draws.keep((B, chunk, U1, m["joint_hidden"]), m["joint_dropout"]) if draws else None
        fc = f_proj[:, i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled():
            b_, l_ = torch.utils.checkpoint.checkpoint(piece, fc, g_proj, keep, use_reentrant=False)
        else:
            b_, l_ = piece(fc, g_proj, keep)
        pb.append(b_)
        pl.append(l_)
    lp_blank = torch.cat(pb, 1)[:, :T]
    lp_label = torch.cat(pl, 1)[:, :T]
    return rnnt_nll(lp_blank, lp_label, t_lens, u_lens).mean()


def ctc_loss(lp, t_lens, labels, u_lens, blank: int):
    nll = F.ctc_loss(lp.transpose(0, 1), labels.long(), t_lens.long(), u_lens.long(), blank=blank,
                     reduction="none", zero_infinity=True)
    return nll.mean()


def step_loss(ref: Reference, batch: dict, cfg: dict, draws):
    """The CL step's loss on one batch, a train-mode forward:
    (1 - w)·RNNT + w·CTC."""
    tr = cfg["train"]
    mel, mel_lens = frontend(batch["audio"], batch["audio_len"], cfg["frontend"], draws)
    if tr["use_spec_augment"]:
        mel = spec_augment(mel, mel_lens, cfg["spec_augment"], draws.host)
    f, t_lens = ref.encode(mel, mel_lens, draws, tr["freeze_encoder_till"])
    g = ref.predict(batch["tokens"], draws)
    f_proj, g_proj = ref.linear(f, "joint.enc"), ref.linear(g, "joint.pred")
    lp = ref.ctc_logprobs(f, batch["lang_ids"])
    lang = int(batch["lang_ids"][0])  # one language a task batch
    rnnt = rnnt_loss(ref, f_proj, g_proj, batch["tokens"], t_lens, batch["token_len"], lang,
                     draws, tr["rnnt_chunk_size"])
    ctc = ctc_loss(lp, t_lens, batch["tokens"], batch["token_len"], ref.V)
    w = tr["ctc_loss_weight"]
    return (1.0 - w) * rnnt + w * ctc


class AdamW:
    """optax.adamw(lr, b1 0.9, b2 0.999, eps 1e-8, weight_decay) over the
    given tensors, in f32."""

    def __init__(self, params: dict, lr: float, wd: float):
        self.params, self.lr, self.wd = params, lr, wd
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.count += 1
        t = torch.tensor(float(self.count))
        bc1 = float(1 - torch.tensor(0.9) ** t)
        bc2 = float(1 - torch.tensor(0.999) ** t)
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(0.9).add_(0.1 * g)
            self.nu[k].mul_(0.999).add_(0.001 * g * g)
            u = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + 1e-8) + self.wd * p
            p.add_(-self.lr * u)
