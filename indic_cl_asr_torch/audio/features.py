"""Log-mel filterbank front-end in PyTorch (eval mode).

Port of indic_cl_asr_tpu/audio/features.py with its ``fft_impl="fft"``
semantics (the reference NeMo FilterbankFeatures.forward,
features.py:400-460):

  wav -> preemphasis(0.97, first sample kept)
      -> STFT(n_fft, a win_length Hann window centred in the n_fft frame,
              hop, center=True reflect padding) -> |.|^2
      -> slaney mel filterbank (built in numpy) -> log(x + 2^-24)
      -> masked per-feature mean / unbiased std + 1e-5
      -> zero fill beyond seq_len, frames padded to a multiple of pad_to

Dither is a training-time augmentation and arrives with the training
slice; this front-end is the eval one (no dither).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16000
    win_length: int = 400          # 25 ms
    hop_length: int = 160          # 10 ms
    n_fft: int = 512
    n_mels: int = 80
    lowfreq: float = 0.0
    highfreq: float | None = None  # None -> sample_rate / 2
    preemph: float | None = 0.97
    log_zero_guard: float = 2.0 ** -24
    mag_power: float = 2.0
    normalize: str = "per_feature"  # "per_feature" | "all_features" | "none"
    pad_to: int = 16
    pad_value: float = 0.0
    std_floor: float = 1e-5


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        f / f_sp,
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel,
        min_log_hz * np.exp(logstep * (m - min_log_mel)),
        f_sp * m,
    )


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    norm: str = "slaney",
) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] triangular filterbank, librosa-compatible
    (slaney mel scale + slaney area norm)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    elif norm not in (None, "none"):
        raise ValueError(f"unsupported mel norm: {norm}")
    return fb.astype(np.float32)


def hann_window(win_length: int, periodic: bool = False) -> np.ndarray:
    """Hann window; periodic=False matches torch.hann_window(periodic=False),
    which the reference uses."""
    if win_length == 1:
        return np.ones(1, dtype=np.float32)
    n = np.arange(win_length, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))).astype(np.float32)


def output_seq_len(num_samples: torch.Tensor, cfg: FrontendConfig):
    """Frame count for the center=True STFT (features.py:391-394)."""
    pad_amount = 2 * (cfg.n_fft // 2)
    return (num_samples + pad_amount - cfg.n_fft) // cfg.hop_length + 1


def _stft_magsq(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, S] f32 -> power spectrogram [B, n_bins, T]."""
    pad = cfg.n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    win = hann_window(cfg.win_length, periodic=False)
    left = (cfg.n_fft - cfg.win_length) // 2
    full_win = np.zeros(cfg.n_fft, dtype=np.float32)
    full_win[left : left + cfg.win_length] = win
    frames = x.unfold(1, cfg.n_fft, cfg.hop_length)  # [B, T, n_fft]
    frames = frames * torch.from_numpy(full_win).to(x.device)
    spec = torch.fft.rfft(frames, dim=-1)
    mag2 = spec.real ** 2 + spec.imag ** 2
    if cfg.mag_power != 2.0:
        mag2 = torch.sqrt(torch.clamp(mag2, min=0.0)) ** cfg.mag_power
    return mag2.transpose(1, 2)


def _valid_frames(seq_len: torch.Tensor, T: int) -> torch.Tensor:
    return (
        torch.arange(T, device=seq_len.device)[None, None, :]
        < seq_len[:, None, None]
    )


def _normalize(x, seq_len, cfg: FrontendConfig, axes):
    """Masked mean / unbiased std + floor over ``axes`` (features.py:59-76
    normalize_batch)."""
    valid = _valid_frames(seq_len, x.shape[-1])
    n = torch.clamp(seq_len.to(x.dtype), min=1.0)[:, None, None]
    if axes == (1, 2):
        n = n * x.shape[1]
    xm = torch.where(valid, x, 0.0)
    mean = xm.sum(dim=axes, keepdim=True) / n
    var = torch.where(valid, (x - mean) ** 2, 0.0).sum(dim=axes, keepdim=True)
    std = torch.sqrt(var / torch.clamp(n - 1.0, min=1.0)) + cfg.std_floor
    return (x - mean) / std


def log_mel_spectrogram(
    signal: torch.Tensor, lengths: torch.Tensor, cfg: FrontendConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S] float audio + [B] sample counts -> ([B, n_mels, T'] f32,
    [B] int32 frame counts)."""
    x = signal.to(torch.float32)
    seq_len = output_seq_len(lengths.to(torch.int64), cfg).to(torch.int32)

    if cfg.preemph is not None:
        x = torch.cat([x[:, :1], x[:, 1:] - cfg.preemph * x[:, :-1]], dim=1)

    spec = _stft_magsq(x, cfg)
    fb = torch.from_numpy(
        mel_filterbank(
            cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.lowfreq, cfg.highfreq
        )
    ).to(x.device)
    mel = torch.einsum("mf,bft->bmt", fb, spec)
    mel = torch.log(mel + cfg.log_zero_guard)

    if cfg.normalize == "per_feature":
        mel = _normalize(mel, seq_len, cfg, axes=-1)
    elif cfg.normalize == "all_features":
        mel = _normalize(mel, seq_len, cfg, axes=(1, 2))

    T = mel.shape[-1]
    mel = torch.where(_valid_frames(seq_len, T), mel, cfg.pad_value)
    if cfg.pad_to > 0 and T % cfg.pad_to != 0:
        mel = F.pad(mel, (0, cfg.pad_to - T % cfg.pad_to), value=cfg.pad_value)
    return mel, seq_len
