"""CTC head with per-language vocabulary slicing (PyTorch).

Port of indic_cl_asr_tpu/models/ctc.py: one aggregate head
[d, V_total + 1] (shared blank last); each sample's logits are its
language's contiguous V_local columns plus the blank column, cast to the
compute dtype, an f32-accumulated product and an f32 log-softmax.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CTCConfig:
    feat_in: int
    vocab_size_total: int
    n_langs: int
    dtype: torch.dtype = torch.float32

    @property
    def vocab_per_lang(self) -> int:
        return self.vocab_size_total // self.n_langs

    @property
    def blank_local(self) -> int:
        return self.vocab_per_lang


class CTCDecoder(nn.Module):
    def __init__(self, cfg: CTCConfig):
        super().__init__()
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.zeros(cfg.feat_in, cfg.vocab_size_total + 1))
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size_total + 1))

    def forward(self, encoded: torch.Tensor, lang_ids: torch.Tensor):
        """encoded [B, T, d] -> f32 log-probs [B, T, V_local + 1], blank last."""
        cfg = self.cfg
        V, L = cfg.vocab_per_lang, cfg.n_langs
        lang = lang_ids.long()
        B = lang.shape[0]
        w_langs = self.kernel[:, : cfg.vocab_size_total].reshape(cfg.feat_in, L, V)
        w = torch.cat(
            [w_langs[:, lang].permute(1, 0, 2),
             self.kernel[:, -1:][None].expand(B, -1, -1)], dim=-1,
        )  # [B, d, V+1]
        b = torch.cat(
            [self.bias[: cfg.vocab_size_total].reshape(L, V)[lang],
             self.bias[-1:][None].expand(B, -1)], dim=-1,
        )
        dt = cfg.dtype
        x = encoded.to(dt).float()
        logits = torch.einsum("btd,bdv->btv", x, w.to(dt).float())
        logits = logits + b.to(dt).float()[:, None]
        return torch.log_softmax(logits, dim=-1)
