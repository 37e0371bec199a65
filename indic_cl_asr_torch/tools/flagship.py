"""The flagship training step at the JAX package's benchmark working point
(bench.py:_setup), shared by scripts/profile_step.py and
scripts/flops_audit.py.

The working point: the flagship config (17 layers, d512 in 8 heads, bf16)
on the flash attention route, encoder layers 0-11 frozen; AdamW at lr
1e-4 over the trainable parameters; StepConfig(rnnt_chunk_size=64,
uniform_lang_head=True, rnnt_remat="none") (the chunked "xla" joint, CTC
weight 0.5); a batch of B16 x 8 s of seeded noise (numpy
``default_rng(0)``, 0.1 std), U 48 tokens drawn from the language's
vocabulary, every row language 0. Random weights from
``init_weights_`` with seed 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..audio.features import FrontendConfig
from ..device import resolve_device
from ..models.hybrid import HybridModelConfig, HybridRNNTCTC, flagship_config, init_weights_
from ..train.state import make_optimizer
from ..train.step import StepConfig, make_train_step

# analytic fwd+bwd FLOPs a step at this working point (bench.py:61,
# ANALYTIC_STEP_TFLOPS: the derivation is in bench.py's docstring)
ANALYTIC_STEP_TFLOPS = 1.5
FROZEN_TILL = 12
BATCH, SECONDS, TOKENS = 16, 8, 48


@dataclasses.dataclass
class FlagshipStep:
    model: HybridRNNTCTC
    step_cfg: StepConfig
    optimizer: object
    step: object            # step(batch, generator) -> aux
    batch: dict             # the step's dict of tensors on the device


def flagship_step(device=None, cfg: HybridModelConfig | None = None,
                  batch: int = BATCH, seconds: float = SECONDS,
                  tokens: int = TOKENS) -> FlagshipStep:
    """The step and its batch on ``device`` (``None``: the card). ``cfg``
    and the batch's shape default to the working point (tests pass a tiny
    config and batch)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = flagship_config(torch.bfloat16, attn_impl="flash", frozen_till=FROZEN_TILL)
    model = HybridRNNTCTC(cfg, device=dev)
    init_weights_(model, torch.Generator().manual_seed(0))
    opt = make_optimizer(model, lr=1e-4, freeze_encoder_till=cfg.encoder.frozen_till,
                         device=dev)
    step_cfg = StepConfig(frontend=FrontendConfig(n_mels=cfg.encoder.feat_in),
                          rnnt_chunk_size=64, uniform_lang_head=True, rnnt_remat="none")
    S = int(16000 * seconds)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((batch, S))).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_per_lang, (batch, tokens)).astype(np.int32)
    lens = np.full((batch,), S, np.int32)
    as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    data = {"audio": as_t(audio), "audio_len": as_t(lens),
            "audio_len_host": torch.from_numpy(lens),
            "tokens": as_t(toks), "token_len": as_t(np.full((batch,), tokens, np.int32)),
            "lang_ids": as_t(np.zeros((batch,), np.int32)), "n_valid": batch}
    return FlagshipStep(model, step_cfg, opt, make_train_step(model, step_cfg, opt, device=dev),
                        data)
