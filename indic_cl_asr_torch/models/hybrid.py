"""Hybrid RNNT+CTC model assembly (PyTorch, serving and training).

Port of indic_cl_asr_tpu/models/hybrid.py: one module with the encoder,
prediction net, joint and CTC head, and the entry points ``encode``,
``predict``, ``joint_project``, ``joint_project_enc``, ``pred_step``,
``joint_step`` and ``ctc_logprobs``. The flagship preset is the reference
checkpoint's architecture (17-layer d512 Conformer, 640-d 1-layer LSTM
prediction net, 640-d joint, 12 languages x 256 tokens + blank per
language head).

The model is built on an explicit device (the card unless ``device="cpu"``
is passed), in eval mode and with no parameter requiring grad (serving);
``train/state.py:make_optimizer`` marks the trainable ones. Parameters and
BatchNorm statistics are f32 (the JAX package's ``init_model``); every
module computes in ``cfg.dtype``, casting the weights where it uses them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from .common import Rngs
from .conformer import (BatchNorm, ConformerConfig, ConformerEncoder, GroupNorm,
                        RelPosSelfAttention)
from .ctc import CTCConfig, CTCDecoder
from .rnnt import LSTM, JointConfig, PredictionConfig, PredictionNetwork, RNNTJoint


@dataclasses.dataclass(frozen=True)
class HybridModelConfig:
    encoder: ConformerConfig = ConformerConfig()
    vocab_size_total: int = 3072
    n_langs: int = 12
    pred_hidden: int = 640
    pred_rnn_layers: int = 1
    pred_dropout: float = 0.2
    joint_hidden: int = 640
    joint_activation: str = "relu"  # or "tanh" / "sigmoid"
    joint_dropout: float = 0.2
    dtype: torch.dtype = torch.float32  # compute dtype of every module

    @property
    def vocab_per_lang(self) -> int:
        return self.vocab_size_total // self.n_langs

    @property
    def blank_local(self) -> int:
        return self.vocab_per_lang

    def encoder_config(self) -> ConformerConfig:
        return dataclasses.replace(self.encoder, dtype=self.dtype)

    def prediction_config(self) -> PredictionConfig:
        return PredictionConfig(
            vocab_size_total=self.vocab_size_total,
            pred_hidden=self.pred_hidden,
            pred_rnn_layers=self.pred_rnn_layers,
            dropout=self.pred_dropout,
            dtype=self.dtype,
        )

    def joint_config(self) -> JointConfig:
        return JointConfig(
            vocab_size_total=self.vocab_size_total,
            n_langs=self.n_langs,
            encoder_hidden=self.encoder.d_model,
            pred_hidden=self.pred_hidden,
            joint_hidden=self.joint_hidden,
            activation=self.joint_activation,
            dropout=self.joint_dropout,
            dtype=self.dtype,
        )

    def ctc_config(self) -> CTCConfig:
        return CTCConfig(
            feat_in=self.encoder.d_model,
            vocab_size_total=self.vocab_size_total,
            n_langs=self.n_langs,
            dtype=self.dtype,
        )


def tiny_config(**overrides) -> HybridModelConfig:
    """CPU-testable config, the same shapes (and no dropout) as the JAX
    package's tiny_config."""
    enc = ConformerConfig(
        feat_in=32, n_layers=2, d_model=64, n_heads=4,
        ff_expansion_factor=2, conv_kernel_size=7, subsampling_factor=4,
        dropout=0.0, dropout_att=0.0, dropout_pre_encoder=0.0,
    )
    base = dict(encoder=enc, vocab_size_total=64, n_langs=4, pred_hidden=32,
                joint_hidden=32, pred_dropout=0.0, joint_dropout=0.0)
    base.update(overrides)
    return HybridModelConfig(**base)


def flagship_config(
    dtype=torch.bfloat16, n_layers: int = 17, attn_impl: str = "xla",
    frozen_till: int = 0,
) -> HybridModelConfig:
    """The reference checkpoint's architecture, with the JAX package's
    flagship dropouts (0.1 encoder and attention, 0.2 prediction net and
    joint)."""
    return HybridModelConfig(
        encoder=ConformerConfig(
            feat_in=80, n_layers=n_layers, d_model=512, n_heads=8,
            ff_expansion_factor=4, conv_kernel_size=31,
            subsampling_factor=4, attn_impl=attn_impl,
            frozen_till=frozen_till,
        ),
        vocab_size_total=3072,
        n_langs=12,
        pred_hidden=640,
        joint_hidden=640,
        dtype=dtype,
    )


class HybridRNNTCTC(nn.Module):
    def __init__(self, cfg: HybridModelConfig, device=None):
        dev = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg.encoder_config())
        self.prediction = PredictionNetwork(cfg.prediction_config())
        self.joint = RNNTJoint(cfg.joint_config())
        self.ctc_decoder = CTCDecoder(cfg.ctc_config())
        self.to(device=dev)
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.joint.head_kernel.device

    @property
    def frozen_till(self) -> int:
        """Encoder layers [0, frozen_till) (and pre_encode) carry no gradient."""
        return self.cfg.encoder.frozen_till

    def encode(self, feats, feat_lens, rngs: Rngs | None = None):
        return self.encoder(feats, feat_lens, rngs)

    def predict(self, tokens, add_sos: bool = True, state=None,
                rngs: Rngs | None = None):
        """[B, U] aggregate label ids -> (g [B, U+1, Hp], states), the
        blank SOS in front when ``add_sos``."""
        return self.prediction(tokens, state, add_sos=add_sos,
                               generator=rngs.device if rngs else None)

    def joint_project(self, f, g):
        """(f [B, T, d], g [B, U+1, Hp]) -> (f_proj, g_proj) [.., H_joint]."""
        return self.joint.project_enc(f), self.joint.project_pred(g)

    def joint_project_enc(self, f):
        return self.joint.project_enc(f)

    def joint_step(self, f_t, g_t, lang_ids):
        return self.joint.step_logits(f_t, g_t, lang_ids)

    def pred_step(self, last_label, state):
        """[B] LOCAL labels + state -> (projected g [B, H_joint], state).
        The decode blank (vocab_per_lang) maps to the zero pad row of the
        aggregate embedding, like training's SOS."""
        label = torch.where(
            last_label == self.cfg.blank_local,
            self.cfg.vocab_size_total, last_label.long(),
        )
        g, new_state = self.prediction(label[:, None], state)
        return self.joint.project_pred(g[:, 0]), new_state

    def ctc_logprobs(self, encoded, lang_ids, return_logits: bool = False):
        return self.ctc_decoder(encoded, lang_ids, return_logits=return_logits)


@torch.no_grad()
def init_weights_(model: HybridRNNTCTC, generator: torch.Generator) -> HybridRNNTCTC:
    """Seeded random weights: lecun-normal matrices (std 1/sqrt(fan_in)),
    zero biases, unit norms, a unit-normal embedding. Draws on the CPU from
    ``generator``, so a seed gives the same weights on every device."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            normal_(m.weight, m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, BatchNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LSTM):
            normal_(m.w_ih, m.w_ih.shape[0] ** -0.5)
            normal_(m.w_hh, m.w_hh.shape[0] ** -0.5)
            m.bias.zero_()
        elif isinstance(m, RelPosSelfAttention):
            m.pos_bias_u.zero_()
            m.pos_bias_v.zero_()
    normal_(model.prediction.embedding, 1.0)
    normal_(model.joint.head_kernel, model.cfg.joint_hidden ** -0.5)
    model.joint.head_bias.zero_()
    normal_(model.ctc_decoder.kernel, model.cfg.encoder.d_model ** -0.5)
    model.ctc_decoder.bias.zero_()
    return model
