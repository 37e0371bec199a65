"""Audio file IO without native deps.

The reference decodes audio via libsndfile/pydub/ffmpeg
(NeMo parts/preprocessing/segment.py:178-277). In this environment we
implement WAV (PCM16/24/32, float32) with the stdlib, fall back to an
``ffmpeg`` subprocess for other containers (e.g. IndicSUPERB .m4a) when the
binary exists, and raise a clear error otherwise.
"""

from __future__ import annotations

import shutil
import subprocess
import wave

import numpy as np


def _pcm_to_float(raw: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    if sampwidth == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported PCM sample width: {sampwidth}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    return x


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono samples in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        x = _pcm_to_float(raw, w.getsampwidth(), w.getnchannels())
    return x, sr


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    x = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def _read_via_ffmpeg(path: str, target_sr: int | None) -> tuple[np.ndarray, int]:
    sr = target_sr or 16000
    cmd = [
        "ffmpeg", "-nostdin", "-i", path, "-f", "f32le", "-acodec",
        "pcm_f32le", "-ac", "1", "-ar", str(sr), "pipe:1",
    ]
    out = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, check=True
    ).stdout
    return np.frombuffer(out, dtype="<f4").copy(), sr


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Cheap linear resampler (host-side, rare path)."""
    if sr_in == sr_out:
        return x
    n_out = int(round(len(x) * sr_out / sr_in))
    t_out = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    return np.interp(t_out, np.arange(len(x), dtype=np.float64), x).astype(
        np.float32
    )


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    """Decode any supported file to float32 mono at ``target_sr``."""
    if path.lower().endswith(".wav"):
        x, sr = read_wav(path)
        return resample_linear(x, sr, target_sr)
    if shutil.which("ffmpeg"):
        x, _ = _read_via_ffmpeg(path, target_sr)
        return x
    raise RuntimeError(
        f"cannot decode {path!r}: not a WAV and no ffmpeg binary available"
    )
