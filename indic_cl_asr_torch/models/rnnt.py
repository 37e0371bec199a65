"""RNNT prediction network and joint with per-language heads (PyTorch).

Port of indic_cl_asr_tpu/models/rnnt.py:

  * prediction net: an embedding of V_total + 1 rows whose last (blank)
    row reads as zero, then an LSTM stack with torch's gate order
    (i, f, g, o), weights in the JAX layout w_ih [D, 4H], w_hh [H, 4H],
    bias [4H]; the cell state is f32 and the gate math runs in the compute
    dtype. In training the label sequence gets a blank SOS in front
    (U+1 steps) and dropout follows the LSTM stack;
  * joint: enc/pred projections, relu (the flagship's activation), and a
    stacked per-language head [L, H, V_local + 1] (blank last) gathered per
    sample; logits in f32.

The LSTM (the JAX package runs it as a ``lax.scan`` outside any Pallas
kernel) has two paths. A step from a given state (decoding) is a Python
step of PyTorch ops with the JAX rounding: gates in the compute dtype, c
carried in f32. A whole sequence from the zero state (training's U+1 <= 129
label steps) is one ``torch.lstm`` call, which keeps ~4000 small launches
a training step off the host; in f32 it equals the step loop up to the
order of f32 sums, in bf16 it keeps the gates and the cell in f32 inside
the op (more precise than the JAX package's bf16 gates).
Parameters are f32, cast to the compute dtype at use.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dense, cast, dropout


@dataclasses.dataclass(frozen=True)
class PredictionConfig:
    vocab_size_total: int
    pred_hidden: int = 640
    pred_rnn_layers: int = 1
    dropout: float = 0.2
    dtype: torch.dtype = torch.float32

    @property
    def blank_idx(self) -> int:
        return self.vocab_size_total


@dataclasses.dataclass(frozen=True)
class JointConfig:
    vocab_size_total: int
    n_langs: int
    encoder_hidden: int = 512
    pred_hidden: int = 640
    joint_hidden: int = 640
    dropout: float = 0.2
    dtype: torch.dtype = torch.float32

    @property
    def vocab_per_lang(self) -> int:
        return self.vocab_size_total // self.n_langs

    @property
    def blank_local(self) -> int:
        return self.vocab_per_lang


class LSTM(nn.Module):
    """One LSTM layer in the JAX layout (so weights load as they are)."""

    def __init__(self, d_in: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.w_ih = nn.Parameter(torch.zeros(d_in, 4 * hidden))
        self.w_hh = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, x, h0=None, c0=None):
        # x: [B, U, D] -> (out [B, U, H], (h, c))
        if h0 is None and c0 is None and x.shape[1] > 1:
            return self.sequence(x)
        return self.steps(x, h0, c0)

    def sequence(self, x):
        """The whole sequence from the zero state in one ``torch.lstm``."""
        B, U, _ = x.shape
        dt = self.dtype
        zeros = torch.zeros((1, B, self.hidden), dtype=dt, device=x.device)
        weights = [self.w_ih.t().to(dt).contiguous(), self.w_hh.t().to(dt).contiguous(),
                   self.bias.to(dt), torch.zeros_like(self.bias, dtype=dt)]
        with warnings.catch_warnings():
            # cuDNN packs these (a few MB) into its own buffer on every call
            # and says so; the module holds no flat buffer of its own
            warnings.filterwarnings("ignore", "RNN module weights are not part")
            out, h, c = torch.lstm(x.to(dt), (zeros, zeros), weights, True, 1, 0.0,
                                   self.training, False, True)
        return out, (h[0], c[0].to(torch.float32))

    def steps(self, x, h0=None, c0=None):
        """Step by step in Python ops, with the JAX package's rounding."""
        B, U, _ = x.shape
        dt = self.dtype
        h = h0 if h0 is not None else torch.zeros(
            (B, self.hidden), dtype=dt, device=x.device
        )
        c = c0 if c0 is not None else torch.zeros(
            (B, self.hidden), dtype=torch.float32, device=x.device
        )
        w_hh = cast(self.w_hh, dt)
        xw = x.to(dt) @ cast(self.w_ih, dt) + cast(self.bias, dt)  # [B, U, 4H]
        outs = []
        for u in range(U):
            gates = xw[:, u] + h @ w_hh
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
            c_dt = f * c.to(dt) + i * g
            h = o * torch.tanh(c_dt)
            c = c_dt.to(torch.float32)
            outs.append(h)
        return torch.stack(outs, dim=1), (h, c)


class PredictionNetwork(nn.Module):
    def __init__(self, cfg: PredictionConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.pred_hidden
        self.embedding = nn.Parameter(torch.zeros(cfg.vocab_size_total + 1, H))
        self.lstm = nn.ModuleList(
            LSTM(H, H, dtype=cfg.dtype) for _ in range(cfg.pred_rnn_layers)
        )

    def forward(self, tokens: torch.Tensor, state=None, add_sos: bool = False,
                generator: torch.Generator | None = None):
        """tokens [B, U] aggregate ids (vocab_size_total reads the zero
        blank row) -> (h [B, U(+1), H], ((h, c) per layer)). ``add_sos``
        puts the blank SOS in front (training); dropout after the stack
        applies in train mode, drawn from ``generator``."""
        cfg = self.cfg
        tokens = tokens.long()
        if add_sos:
            sos = torch.full((tokens.shape[0], 1), cfg.blank_idx,
                             dtype=tokens.dtype, device=tokens.device)
            tokens = torch.cat([sos, tokens], dim=1)
        emb = self.embedding[tokens.clamp(0, cfg.vocab_size_total)]
        emb = torch.where((tokens == cfg.blank_idx)[..., None], 0.0, emb).to(cfg.dtype)
        new_states = []
        h = emb
        for i, layer in enumerate(self.lstm):
            h0c0 = state[i] if state is not None else (None, None)
            h, (hn, cn) = layer(h, *h0c0)
            new_states.append((hn, cn))
        h = dropout(h, cfg.dropout, generator, self.training)
        return h, tuple(new_states)


class RNNTJoint(nn.Module):
    def __init__(self, cfg: JointConfig):
        super().__init__()
        self.cfg = cfg
        self.enc = Dense(cfg.encoder_hidden, cfg.joint_hidden, dtype=cfg.dtype)
        self.pred = Dense(cfg.pred_hidden, cfg.joint_hidden, dtype=cfg.dtype)
        self.head_kernel = nn.Parameter(
            torch.zeros(cfg.n_langs, cfg.joint_hidden, cfg.vocab_per_lang + 1)
        )
        self.head_bias = nn.Parameter(
            torch.zeros(cfg.n_langs, cfg.vocab_per_lang + 1)
        )

    def project_enc(self, f):
        return self.enc(f)

    def project_pred(self, g):
        # the product rounded to the compute dtype, then the bias: Flax
        # Dense's order, and the fused decode kernel's
        dt = self.cfg.dtype
        return F.linear(g.to(dt), cast(self.pred.weight, dt)) + cast(self.pred.bias, dt)

    def step_logits(self, f_t, g_t, lang_ids):
        """Projected f_t [B, H] + projected g_t [B, H] -> [B, V_local+1] f32
        (the head cast to the compute dtype, the f32 bias added)."""
        inp = torch.relu(f_t + g_t)
        lang = lang_ids.long()
        w = self.head_kernel[lang].to(self.cfg.dtype)  # [B, H, V+1]
        b = self.head_bias[lang]
        return torch.einsum("bh,bhv->bv", inp.float(), w.float()) + b.float()
