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

Under a data mesh (parallel/sharding.py) each rank holds its rows of the
global batch: the SpecAugment bands are drawn for the global batch and
each rank keeps its rows; every loss sums this rank's valid rows over the
global count; BatchNorm takes the global batch's statistics; the
gradients and the logged losses are summed over the data ranks in one
all-reduce, and a CL penalty enters once. The data rank is folded into
every kernel seed and the device generator's seed (models/common.py:
fold_rank), so a mesh of one is bit-identical to no mesh.

Under a model axis (parallel/sharding.py:shard_model) the model ranks of
a data rank hold the same rows: the losses, computed whole after the
heads, are summed over the data ranks only; the gradients of the whole
parameters a split region reads a slice of are first summed over the
model ranks; the split regions' draws fold the model rank in, the whole
model's do not, so every model rank holds the same whole tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from ..audio.features import FrontendConfig, log_mel_spectrogram, output_seq_len
from ..audio.spec_augment import SpecAugmentConfig, apply_bands, draw_bands
from ..device import resolve_device
from ..models.common import Rngs
from ..models.conformer import BatchNorm
from ..ops.ctc_loss import IMPLS as CTC_IMPLS
from ..ops.ctc_loss import ctc_loss
from ..ops.rnnt_loss_fused import IMPLS as RNNT_IMPLS
from ..ops.rnnt_loss_fused import REMATS, rnnt_loss_fused
from ..parallel.sharding import all_reduce_sum, model_sum_partial, model_total, reduce_sum
from ..utils.profiling import span
from .state import AdamW


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The JAX package's StepConfig, field for field, with its values:
    ``rnnt_impl`` "xla" (the chunked joint) or "pallas" (the fused joint
    kernels), ``rnnt_remat`` "full", "save_logits" or "none", ``ctc_impl``
    "native" or "optax". ``fast_dropout_rng`` selects a JAX PRNG
    implementation and has no effect here."""

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

    def __post_init__(self):
        for name, value, allowed in (("rnnt_impl", self.rnnt_impl, RNNT_IMPLS),
                                     ("rnnt_remat", self.rnnt_remat, REMATS),
                                     ("ctc_impl", self.ctc_impl, CTC_IMPLS)):
            if value not in allowed:
                raise ValueError(f"{name}={value!r}: one of {allowed}")


def batch_to_device_dict(batch, device) -> dict:
    """A data/pipeline.py Batch -> the step's dict of tensors on ``device``
    (plus ``audio_len_host``, the sample counts on the CPU, from which the
    SpecAugment bands are drawn without waiting on the device). The dict
    is the global batch; parallel/sharding.py:place_batch keeps a data
    rank's rows of it, and ``audio_len_host`` stays the global batch's."""
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


def batch_rows(batch: dict, B: int, device):
    """(row_mask, n_rows) of a batch dict holding B rows from global row
    ``batch["row0"]`` (0 when absent): which of them are real, and the
    real rows of the global batch (``n_valid``), the divisor of every
    per-row mean. (None, None) without ``n_valid``."""
    if batch.get("n_valid") is None:
        return None, None
    row0, n_valid = int(batch.get("row0", 0)), int(batch["n_valid"])
    return torch.arange(row0, row0 + B, device=device) < n_valid, n_valid


def hybrid_forward_tensors(model, step_cfg: StepConfig, audio, audio_lens,
                           tokens, lang_ids, rngs: Rngs | None, train: bool,
                           audio_lens_host=None, row0: int = 0):
    """Shared forward: mel (+ dither and SpecAugment when training) ->
    encoder -> prediction net -> joint projections, the per-sample language
    head slices and the CTC log-probs. ``audio_lens_host`` may be the
    global batch's lengths, of which these rows start at ``row0``: the
    SpecAugment bands are drawn for all of them.

    Returns (f_proj, g_proj, ctc_lp, head_w, head_b, f, enc_lens). In train
    mode BatchNorm statistics are updated in the model's buffers."""
    model.train(train)
    with span("asr.frontend"):
        mel, mel_lens = log_mel_spectrogram(
            audio, audio_lens, step_cfg.frontend, training=train,
            generator=rngs.device if rngs is not None else None,
        )
        if train and step_cfg.use_spec_augment:
            if rngs is None:
                raise ValueError("SpecAugment in train mode needs rngs")
            host_lens = (audio_lens if audio_lens_host is None else audio_lens_host).cpu()
            mel_host_lens = output_seq_len(host_lens.to(torch.int64), step_cfg.frontend)
            bands = draw_bands(mel_host_lens, mel.shape[1], step_cfg.spec_augment, rngs.host)
            rows = slice(row0, row0 + mel.shape[0])
            mel = apply_bands(mel, *(b[rows] for b in bands),
                              mask_value=step_cfg.spec_augment.mask_value)
    with span("asr.encoder"):
        f, enc_lens = model.encode(mel, mel_lens, rngs)
    with span("asr.predict"):
        g, _ = model.predict(tokens, add_sos=True, rngs=rngs)
        f_proj, g_proj = model.joint_project(f, g)
        ctc_lp = model.ctc_logprobs(f, lang_ids)
        lang = lang_ids.long()
        head_kernel, head_bias = model.joint.heads()
        head_w, head_b = head_kernel[lang], head_bias[lang]
    return f_proj, g_proj, ctc_lp, head_w, head_b, f, enc_lens


def hybrid_forward_loss(model, step_cfg: StepConfig, batch: dict,
                        rngs: Rngs | None, train: bool = True,
                        return_pieces: bool = False):
    """(loss, aux) of one batch dict. ``batch["n_valid"]`` marks
    how many leading rows are real: the repeat rows that pad a bucket's
    last batch are left out of both losses' means. With ``return_pieces``
    it returns (loss, aux, (f_proj, g_proj, ctc_lp, head_w, head_b)), the
    tensors of this very forward that LwF distils."""
    f_proj, g_proj, ctc_lp, head_w, head_b, _, enc_lens = hybrid_forward_tensors(
        model, step_cfg, batch["audio"], batch["audio_len"], batch["tokens"],
        batch["lang_ids"], rngs, train, batch.get("audio_len_host"), batch.get("row0", 0),
    )
    row_mask, n_rows = batch_rows(batch, f_proj.shape[0], f_proj.device)
    cfg = model.cfg
    tokens, token_len = batch["tokens"], batch["token_len"]
    with span("asr.rnnt_loss"):
        rnnt = rnnt_loss_fused(
            f_proj, g_proj, head_w, head_b, tokens, enc_lens, token_len,
            blank=cfg.blank_local, activation=cfg.joint_activation, reduction="mean_batch",
            chunk_size=step_cfg.rnnt_chunk_size,
            dropout_rate=cfg.joint_dropout if train else 0.0,
            generator=rngs.device if rngs is not None else None,
            host_generator=rngs.host if rngs is not None else None,
            impl=step_cfg.rnnt_impl, row_mask=row_mask,
            uniform_head=step_cfg.uniform_lang_head, remat=step_cfg.rnnt_remat,
            n_rows=n_rows, seed_rank=rngs.rank if rngs is not None else 0,
        )
    with span("asr.ctc_loss"):
        ctc = ctc_loss(ctc_lp, enc_lens, tokens, token_len, blank=cfg.blank_local,
                       reduction="mean_batch", impl=step_cfg.ctc_impl, row_mask=row_mask,
                       n_rows=n_rows)
    w = step_cfg.ctc_loss_weight
    loss = (1.0 - w) * rnnt + w * ctc
    aux = {"train_rnnt_loss": rnnt, "train_ctc_loss": ctc, "train_loss": loss}
    if return_pieces:
        return loss, aux, (f_proj, g_proj, ctc_lp, head_w, head_b)
    return loss, aux


@contextlib.contextmanager
def data_parallel(mesh, generator: torch.Generator, device, *models):
    """The data-parallel state of one train-mode forward, in one place:
    yields the forward's ``Rngs`` (one draw of ``generator``, this data
    rank folded in, and under a model axis the model rank for the split
    regions), and inside, the BatchNorms of ``models`` take the global
    batch's statistics over ``mesh``'s data ranks. Without a mesh, the
    Rngs of rank 0 and the local statistics."""
    if mesh is None:
        rngs = Rngs.from_host(generator, device)
    else:
        rngs = Rngs.from_host(generator, device, mesh.data_rank, mesh.model_rank, mesh.n_model)
    norms = [m for model in models for m in model.modules() if isinstance(m, BatchNorm)]
    if mesh is not None:
        for m in norms:
            m.sum_over_ranks = lambda sums: (all_reduce_sum(sums, mesh), mesh.n_data)
    try:
        yield rngs
    finally:
        for m in norms:
            m.sum_over_ranks = None


def reduced(mesh, grads, params, aux: dict):
    """(grads, aux) summed over ``mesh``'s data ranks in one all-reduce:
    this rank's gradients (None for an unused parameter: zeros) and its
    share of every loss in ``aux``; under a model axis the partial
    gradients of the whole parameters a split region reads a slice of are
    summed over the model ranks first. Without a mesh: unchanged."""
    if mesh is None:
        return grads, aux
    grads = model_sum_partial(mesh, grads, params)
    keys = list(aux)
    out = reduce_sum(mesh, list(grads) + [aux[k] for k in keys],
                     list(params) + [aux[k] for k in keys])
    return out[:len(grads)], dict(zip(keys, out[len(grads):]))


def make_train_step(model, step_cfg: StepConfig, optimizer: AdamW,
                    penalty_fn: Callable | None = None, device=None, mesh=None):
    """Build ``step(batch, generator) -> aux``: one forward, backward and
    AdamW update of ``model`` in place. ``generator`` is the step's CPU
    torch.Generator. ``device`` defaults to the CUDA card and must be the
    model's (``"cpu"`` for the plain path).

    ``penalty_fn(params) -> (penalty, extra_grads or None)`` hooks the CL
    methods in: ``params`` maps the trainable parameters' names to the
    parameters; a scalar penalty is differentiated on its own and its
    gradients, like explicit ones (EWC's, a dict by name), are added to
    the loss's after the backward; the explicit ones' global norm is
    reported as ``penalty_gnorm``. The aux values are 0-d tensors on the
    device (reading them waits for the step).

    ``mesh`` (parallel/sharding.py:make_mesh) makes the step data
    parallel: ``batch`` is this rank's rows (``place_batch``), BatchNorm
    takes the global batch's statistics, and the gradients and aux losses
    are summed over the data ranks; the penalty, the same on every data
    rank and a function of this rank's shards, enters once, after the
    sums. A model axis runs the model split as ``shard_model`` left it."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, step asked for {dev}")
    names, params = optimizer.names, optimizer.params

    def step(batch: dict, generator: torch.Generator) -> dict:
        with data_parallel(mesh, generator, model.device, model) as rngs:
            loss, aux = hybrid_forward_loss(model, step_cfg, batch, rngs, train=True)
        with span("asr.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads, aux = reduced(mesh, grads, params, aux)
        grads = list(grads)
        if penalty_fn is not None:
            pen, extra = penalty_fn(dict(zip(names, params)))
            aux = dict(aux, penalty=pen.detach(), train_loss=aux["train_loss"] + pen.detach())
            if pen.requires_grad:
                extra = dict(zip(names, torch.autograd.grad(pen, params, allow_unused=True)))
            elif extra is not None:
                pg = [extra.get(n) for n in names]
                aux["penalty_gnorm"] = torch.sqrt(model_total(
                    [(e.float() ** 2).sum() for e in pg if e is not None],
                    [p for p, e in zip(params, pg) if e is not None]))
            if extra is not None:
                grads = [g if e is None else (e if g is None else g + e)
                         for g, e in zip(grads, (extra.get(n) for n in names))]
        with span("asr.optimizer"):
            optimizer.step(grads)
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items()}

    return step
