"""The hybrid RNNT+CTC training step (PyTorch).

Port of indic_cl_asr_tpu/train/step.py:

  waveform -> log-mel (+ train-only dither) -> SpecAugment -> Conformer
  (train mode; no gradient below ``frozen_till``) -> prediction net over
  the whole label sequence -> joint projections -> chunked RNNT loss over
  the alpha/beta lattice kernels, and the CTC head -> CTC loss
  -> loss = (1 - w)·rnnt + w·ctc  [+ an optional CL penalty]
  -> backward (the flash attention backward kernel in every trainable
  layer) -> AdamW over the trainable parameters; BatchNorm statistics are
  updated in place, the frozen layers' included.

Randomness comes from one CPU ``torch.Generator`` per step (``Rngs``): the
SpecAugment bands and the attention kernels' per-layer seeds are drawn on
it, so every device sees the same ones; dither and the dropout masks are
drawn on a device generator seeded from it. JAX keys and torch generators
give different numbers: the port matches the JAX package's draws in
distribution, not in value.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..audio.features import FrontendConfig, log_mel_spectrogram, output_seq_len
from ..audio.spec_augment import SpecAugmentConfig, spec_augment
from ..device import resolve_device
from ..models.common import Rngs
from ..ops.ctc_loss import ctc_loss
from ..ops.rnnt_loss_fused import rnnt_loss_fused
from .state import AdamW


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The JAX package's StepConfig, field for field. ``fast_dropout_rng``
    selects a JAX PRNG implementation and has no effect here;
    ``rnnt_impl="pallas"``, ``rnnt_remat="save_logits"`` and
    ``ctc_impl="optax"`` are not ported yet and raise."""

    frontend: FrontendConfig = FrontendConfig()
    spec_augment: SpecAugmentConfig = SpecAugmentConfig()
    ctc_loss_weight: float = 0.5
    rnnt_chunk_size: int = 64
    use_spec_augment: bool = True
    rnnt_impl: str = "xla"
    rnnt_remat: str = "full"
    ctc_impl: str = "native"
    fast_dropout_rng: bool = True
    # every row uses lang_ids[0]'s head: true of the CL workload, where each
    # task trains one language; the loss is wrong on a mixed batch
    uniform_lang_head: bool = False


def batch_to_device_dict(batch, device) -> dict:
    """A data/pipeline.py Batch -> the step's dict of tensors on ``device``
    (plus ``audio_len_host``, the sample counts on the CPU, from which the
    SpecAugment bands are drawn without waiting on the device)."""
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(a).to(dev, non_blocking=True)  # noqa: E731
    return {
        "audio": as_t(batch.audio),
        "audio_len": as_t(batch.audio_len),
        "audio_len_host": torch.from_numpy(batch.audio_len),
        "tokens": as_t(batch.tokens),
        "token_len": as_t(batch.token_len),
        "lang_ids": as_t(batch.lang_ids),
        "n_valid": int(batch.n_real),
    }


def hybrid_forward_tensors(model, step_cfg: StepConfig, audio, audio_lens,
                           tokens, lang_ids, rngs: Rngs | None, train: bool,
                           audio_lens_host=None):
    """Shared forward: mel (+ dither and SpecAugment when training) ->
    encoder -> prediction net -> joint projections, the per-sample language
    head slices and the CTC log-probs.

    Returns (f_proj, g_proj, ctc_lp, head_w, head_b, f, enc_lens). In train
    mode BatchNorm statistics are updated in the model's buffers."""
    model.train(train)
    mel, mel_lens = log_mel_spectrogram(
        audio, audio_lens, step_cfg.frontend, training=train,
        generator=rngs.device if rngs is not None else None,
    )
    if train and step_cfg.use_spec_augment:
        if rngs is None:
            raise ValueError("SpecAugment in train mode needs rngs")
        host_lens = (audio_lens if audio_lens_host is None else audio_lens_host).cpu()
        mel_host_lens = output_seq_len(host_lens.to(torch.int64), step_cfg.frontend)
        mel = spec_augment(mel, mel_host_lens, rngs.host, step_cfg.spec_augment)
    f, enc_lens = model.encode(mel, mel_lens, rngs)
    g, _ = model.predict(tokens, add_sos=True, rngs=rngs)
    f_proj, g_proj = model.joint_project(f, g)
    ctc_lp = model.ctc_logprobs(f, lang_ids)
    lang = lang_ids.long()
    head_w = model.joint.head_kernel[lang]
    head_b = model.joint.head_bias[lang]
    return f_proj, g_proj, ctc_lp, head_w, head_b, f, enc_lens


def hybrid_forward_loss(model, step_cfg: StepConfig, batch: dict,
                        rngs: Rngs | None, train: bool = True):
    """(loss, aux) of one batch dict. ``batch["n_valid"]`` marks
    how many leading rows are real: the repeat rows that pad a bucket's
    last batch are left out of both losses' means."""
    f_proj, g_proj, ctc_lp, head_w, head_b, _, enc_lens = hybrid_forward_tensors(
        model, step_cfg, batch["audio"], batch["audio_len"], batch["tokens"],
        batch["lang_ids"], rngs, train, batch.get("audio_len_host"),
    )
    B = f_proj.shape[0]
    row_mask = None
    if batch.get("n_valid") is not None:
        row_mask = torch.arange(B, device=f_proj.device) < int(batch["n_valid"])
    cfg = model.cfg
    tokens, token_len = batch["tokens"], batch["token_len"]
    rnnt = rnnt_loss_fused(
        f_proj, g_proj, head_w, head_b, tokens, enc_lens, token_len,
        blank=cfg.blank_local, reduction="mean_batch",
        chunk_size=step_cfg.rnnt_chunk_size,
        dropout_rate=cfg.joint_dropout if train else 0.0,
        generator=rngs.device if rngs is not None else None,
        impl=step_cfg.rnnt_impl, row_mask=row_mask,
        uniform_head=step_cfg.uniform_lang_head, remat=step_cfg.rnnt_remat,
    )
    if step_cfg.ctc_impl != "native":
        raise NotImplementedError(f"ctc_impl={step_cfg.ctc_impl!r}: the port has 'native'")
    ctc = ctc_loss(ctc_lp, enc_lens, tokens, token_len, blank=cfg.blank_local,
                   reduction="mean_batch", row_mask=row_mask)
    w = step_cfg.ctc_loss_weight
    loss = (1.0 - w) * rnnt + w * ctc
    aux = {"train_rnnt_loss": rnnt, "train_ctc_loss": ctc, "train_loss": loss}
    return loss, aux


def make_train_step(model, step_cfg: StepConfig, optimizer: AdamW,
                    penalty_fn: Callable | None = None, device=None):
    """Build ``step(batch, generator) -> aux``: one forward, backward and
    AdamW update of ``model`` in place. ``generator`` is the step's CPU
    torch.Generator. ``device`` defaults to the CUDA card and must be the
    model's (``"cpu"`` for the plain path).

    ``penalty_fn(params) -> (penalty, extra_grads or None)`` hooks the CL
    methods in: ``params`` maps the trainable parameters' names to the
    parameters; a scalar penalty is differentiated with the loss, and
    explicit gradients (EWC's, a dict by name) are added after the
    backward, their global norm reported as ``penalty_gnorm``. The aux
    values are 0-d tensors on the device (reading them waits for the
    step)."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, step asked for {dev}")
    names, params = optimizer.names, optimizer.params

    def step(batch: dict, generator: torch.Generator) -> dict:
        rngs = Rngs.from_host(generator, model.device)
        loss, aux = hybrid_forward_loss(model, step_cfg, batch, rngs, train=True)
        extra = None
        if penalty_fn is not None:
            pen, extra = penalty_fn(dict(zip(names, params)))
            loss = loss + pen
            aux = dict(aux, penalty=pen, train_loss=loss)
        grads = list(torch.autograd.grad(loss, params, allow_unused=True))
        if extra is not None:
            pg = [extra.get(n) for n in names]
            aux["penalty_gnorm"] = torch.sqrt(sum(
                (e.float() ** 2).sum() for e in pg if e is not None))
            grads = [g if e is None else (e if g is None else g + e)
                     for g, e in zip(grads, pg)]
        optimizer.step(grads)
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items()}

    return step
