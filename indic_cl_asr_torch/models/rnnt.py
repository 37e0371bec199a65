"""RNNT prediction network and joint with per-language heads (PyTorch).

Port of indic_cl_asr_tpu/models/rnnt.py:

  * prediction net: an embedding of V_total + 1 rows whose last (blank)
    row reads as zero, then an LSTM stack with torch's gate order
    (i, f, g, o), weights in the JAX layout w_ih [D, 4H], w_hh [H, 4H],
    bias [4H]; the cell state is f32 and the gate math runs in the compute
    dtype;
  * joint: enc/pred projections, relu (the flagship's activation), and a
    stacked per-language head [L, H, V_local + 1] (blank last) gathered per
    sample; logits in f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class PredictionConfig:
    vocab_size_total: int
    pred_hidden: int = 640
    pred_rnn_layers: int = 1

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

    @property
    def vocab_per_lang(self) -> int:
        return self.vocab_size_total // self.n_langs

    @property
    def blank_local(self) -> int:
        return self.vocab_per_lang


class LSTM(nn.Module):
    """One LSTM layer in the JAX layout (so weights load as they are)."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_ih = nn.Parameter(torch.zeros(d_in, 4 * hidden))
        self.w_hh = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, x, h0=None, c0=None):
        # x: [B, U, D] -> (out [B, U, H], (h, c))
        B, U, _ = x.shape
        dt = self.w_ih.dtype
        h = h0 if h0 is not None else torch.zeros(
            (B, self.hidden), dtype=dt, device=x.device
        )
        c = c0 if c0 is not None else torch.zeros(
            (B, self.hidden), dtype=torch.float32, device=x.device
        )
        xw = x.to(dt) @ self.w_ih + self.bias  # [B, U, 4H]
        outs = []
        for u in range(U):
            gates = xw[:, u] + h @ self.w_hh
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
        self.lstm = nn.ModuleList(LSTM(H, H) for _ in range(cfg.pred_rnn_layers))

    def forward(self, tokens: torch.Tensor, state=None):
        """tokens [B, U] aggregate ids (vocab_size_total reads the zero
        blank row) -> (h [B, U, H], ((h, c) per layer))."""
        cfg = self.cfg
        tokens = tokens.long()
        emb = self.embedding[tokens.clamp(0, cfg.vocab_size_total)]
        emb = torch.where((tokens == cfg.blank_idx)[..., None], 0.0, emb)
        new_states = []
        h = emb
        for i, layer in enumerate(self.lstm):
            h0c0 = state[i] if state is not None else (None, None)
            h, (hn, cn) = layer(h, *h0c0)
            new_states.append((hn, cn))
        return h, tuple(new_states)


class RNNTJoint(nn.Module):
    def __init__(self, cfg: JointConfig):
        super().__init__()
        self.cfg = cfg
        self.enc = nn.Linear(cfg.encoder_hidden, cfg.joint_hidden)
        self.pred = nn.Linear(cfg.pred_hidden, cfg.joint_hidden)
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
        return F.linear(g, self.pred.weight) + self.pred.bias

    def step_logits(self, f_t, g_t, lang_ids):
        """Projected f_t [B, H] + projected g_t [B, H] -> [B, V_local+1] f32."""
        inp = torch.relu(f_t + g_t)
        lang = lang_ids.long()
        w = self.head_kernel[lang]  # [B, H, V+1]
        b = self.head_bias[lang]
        return torch.einsum("bh,bhv->bv", inp.float(), w.float()) + b.float()
