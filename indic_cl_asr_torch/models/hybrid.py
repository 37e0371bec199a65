"""Hybrid RNNT+CTC model assembly (PyTorch, serving).

Port of indic_cl_asr_tpu/models/hybrid.py: one module with the encoder,
prediction net, joint and CTC head, and the decode entry points
``encode``, ``joint_project_enc``, ``pred_step``, ``joint_step`` and
``ctc_logprobs``. The flagship preset is the reference checkpoint's
architecture (17-layer d512 Conformer, 640-d 1-layer LSTM prediction net,
640-d joint, 12 languages x 256 tokens + blank per language head).

The model is built on an explicit device (the card unless ``device="cpu"``
is passed) in its compute dtype, in eval mode; training arrives with the
training slice, and ``train()`` raises until then.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from .conformer import (
    BatchNormEval,
    ConformerConfig,
    ConformerEncoder,
    RelPosSelfAttention,
)
from .ctc import CTCConfig, CTCDecoder
from .rnnt import LSTM, JointConfig, PredictionConfig, PredictionNetwork, RNNTJoint


@dataclasses.dataclass(frozen=True)
class HybridModelConfig:
    encoder: ConformerConfig = ConformerConfig()
    vocab_size_total: int = 3072
    n_langs: int = 12
    pred_hidden: int = 640
    pred_rnn_layers: int = 1
    joint_hidden: int = 640
    dtype: torch.dtype = torch.float32  # compute dtype of every module

    @property
    def vocab_per_lang(self) -> int:
        return self.vocab_size_total // self.n_langs

    @property
    def blank_local(self) -> int:
        return self.vocab_per_lang

    def prediction_config(self) -> PredictionConfig:
        return PredictionConfig(
            vocab_size_total=self.vocab_size_total,
            pred_hidden=self.pred_hidden,
            pred_rnn_layers=self.pred_rnn_layers,
        )

    def joint_config(self) -> JointConfig:
        return JointConfig(
            vocab_size_total=self.vocab_size_total,
            n_langs=self.n_langs,
            encoder_hidden=self.encoder.d_model,
            pred_hidden=self.pred_hidden,
            joint_hidden=self.joint_hidden,
        )

    def ctc_config(self) -> CTCConfig:
        return CTCConfig(
            feat_in=self.encoder.d_model,
            vocab_size_total=self.vocab_size_total,
            n_langs=self.n_langs,
        )


def tiny_config(**overrides) -> HybridModelConfig:
    """CPU-testable config, the same shapes as the JAX package's tiny_config."""
    enc = ConformerConfig(
        feat_in=32, n_layers=2, d_model=64, n_heads=4,
        ff_expansion_factor=2, conv_kernel_size=7, subsampling_factor=4,
    )
    base = dict(encoder=enc, vocab_size_total=64, n_langs=4, pred_hidden=32,
                joint_hidden=32)
    base.update(overrides)
    return HybridModelConfig(**base)


def flagship_config(
    dtype=torch.bfloat16, n_layers: int = 17, attn_impl: str = "xla"
) -> HybridModelConfig:
    return HybridModelConfig(
        encoder=ConformerConfig(
            feat_in=80, n_layers=n_layers, d_model=512, n_heads=8,
            ff_expansion_factor=4, conv_kernel_size=31,
            subsampling_factor=4, attn_impl=attn_impl,
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
        self.encoder = ConformerEncoder(cfg.encoder)
        self.prediction = PredictionNetwork(cfg.prediction_config())
        self.joint = RNNTJoint(cfg.joint_config())
        self.ctc_decoder = CTCDecoder(cfg.ctc_config())
        self.to(device=dev, dtype=cfg.dtype)
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError(
                "training (dropout, SpecAugment, batch statistics) arrives "
                "with the training slice"
            )
        return super().train(False)

    @property
    def device(self) -> torch.device:
        return self.joint.head_kernel.device

    def encode(self, feats, feat_lens):
        return self.encoder(feats, feat_lens)

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

    def ctc_logprobs(self, encoded, lang_ids):
        return self.ctc_decoder(encoded, lang_ids)


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
        elif isinstance(m, (nn.LayerNorm, BatchNormEval)):
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
