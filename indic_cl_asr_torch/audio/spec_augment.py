"""SpecAugment: band draws and band masks (PyTorch).

Port of indic_cl_asr_tpu/audio/spec_augment.py (reference NeMo
spectr_augment.py:25-113): per batch row, ``freq_masks`` bands with start
~ U{0..F-freq_width} and width ~ U{0..freq_width}, and ``time_masks``
bands whose widest is ``w_max = max(1, int(len * time_width))`` for a
float ``time_width`` (adaptive), start ~ U{0..max(1, len - w_max)} and
width ~ U{0..w_max}; every bound inclusive (python random.randint).

Split in two: ``draw_bands`` draws the [B, M] integers on a CPU generator
(a few hundred numbers a step), ``apply_bands`` masks the spectrogram on
its own device. A test can feed the JAX package's bands to
``apply_bands``, and a card and the CPU given the same generator state see
the same masks.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    freq_masks: int = 2
    time_masks: int = 10
    freq_width: int = 27
    time_width: float = 0.05  # float -> adaptive fraction of utterance length
    mask_value: float = 0.0


def _uniform_upto(hi: torch.Tensor, shape, generator) -> torch.Tensor:
    """Integers uniform over [0, hi] (inclusive), hi [B] broadcast over M."""
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return torch.minimum((u * (hi[:, None] + 1).double()).long(), hi[:, None])


def draw_bands(lengths: torch.Tensor, n_freq: int, cfg: SpecAugmentConfig,
               generator: torch.Generator):
    """[B] valid frame counts (CPU) -> (f_start, f_width, t_start, t_width),
    each [B, M] int64 on the CPU."""
    lengths = lengths.to(device="cpu", dtype=torch.int64)
    B = lengths.shape[0]
    fw = cfg.freq_width
    f_hi = torch.full((B,), max(n_freq - fw, 0), dtype=torch.int64)
    f_start = _uniform_upto(f_hi, (B, cfg.freq_masks), generator)
    f_width = _uniform_upto(torch.full((B,), fw, dtype=torch.int64),
                            (B, cfg.freq_masks), generator)
    if isinstance(cfg.time_width, float) and cfg.time_width <= 1.0:
        w_max = torch.clamp(
            (lengths.to(torch.float32) * cfg.time_width).to(torch.int64), min=1
        )
    else:
        w_max = torch.full((B,), int(cfg.time_width), dtype=torch.int64)
    start_ub = torch.clamp(lengths - w_max, min=1)
    t_start = _uniform_upto(start_ub, (B, cfg.time_masks), generator)
    t_width = _uniform_upto(w_max, (B, cfg.time_masks), generator)
    return f_start, f_width, t_start, t_width


def _band_mask(starts, widths, size: int, device) -> torch.Tensor:
    """[B, M] starts/widths -> [B, size] bool OR of the bands."""
    iota = torch.arange(size, device=device)[None, None, :]
    s = starts.to(device)[:, :, None]
    w = widths.to(device)[:, :, None]
    return ((iota >= s) & (iota < s + w)).any(dim=1)


def apply_bands(spec: torch.Tensor, f_start, f_width, t_start, t_width,
                mask_value: float = 0.0) -> torch.Tensor:
    """[B, F, T] spectrogram with the bands set to ``mask_value``."""
    B, F, T = spec.shape
    if f_start.shape[1] > 0:
        fmask = _band_mask(f_start, f_width, F, spec.device)
        spec = torch.where(fmask[:, :, None], mask_value, spec)
    if t_start.shape[1] > 0:
        tmask = _band_mask(t_start, t_width, T, spec.device)
        spec = torch.where(tmask[:, None, :], mask_value, spec)
    return spec


def spec_augment(spec: torch.Tensor, lengths: torch.Tensor,
                 generator: torch.Generator,
                 cfg: SpecAugmentConfig = SpecAugmentConfig()) -> torch.Tensor:
    """[B, F, T] spectrogram, [B] valid frame counts (CPU) -> masked
    [B, F, T]; the bands are drawn from the CPU ``generator``."""
    bands = draw_bands(lengths, spec.shape[1], cfg, generator)
    return apply_bands(spec, *bands, mask_value=cfg.mask_value)
