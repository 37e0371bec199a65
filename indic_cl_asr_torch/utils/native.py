"""ctypes bindings for the port's native host runtime (csrc/host/*.cpp).

Port of indic_cl_asr_tpu/utils/native.py over the port's own copy of the
sources: a threaded WAV batch loader (``load_wav_batch_native``, used by
data/pipeline.py) and Levenshtein distance (``edit_distance_native``,
``edit_distance_batch``, used by train/metrics.py).

``g++`` builds the library at first use into
``build/torch_host/libindic_host-<hash>.so`` inside the checkout, the hash
taken over the sources, so an edited source is rebuilt and a stale library
is never loaded; the compiler writes to a temporary name that is then
moved into place, so processes that build at once do not read a partial
file. Nothing is built when the module is imported. Unlike the JAX module,
a failed build or load raises (with the compiler's output): no caller
falls back to Python because the library is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "host" / "editdistance.cpp",
           _PKG / "csrc" / "host" / "audio_loader.cpp")
BUILD_DIR = _PKG.parent / "build" / "torch_host"
COMPILE = ("g++", "-O3", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)).hexdigest()[:12]
    return BUILD_DIR / f"libindic_host-{digest}.so"


def build() -> Path:
    """Compile the library if it is not built yet; its path. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*COMPILE, *map(str, SOURCES), "-shared", "-lpthread", "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run the host compiler {cmd[0]!r}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native host library failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64, P = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        lib.edit_distance_i64.restype = i64
        lib.edit_distance_i64.argtypes = [P, i64, P, i64]
        lib.edit_distance_batch_i64.restype = None
        lib.edit_distance_batch_i64.argtypes = [P, P, P, P, i64, P, i64]
        lib.load_wav_batch.restype = ctypes.c_int
        lib.load_wav_batch.argtypes = [
            ctypes.c_char_p, i64, i64, i64, ctypes.POINTER(ctypes.c_float), P, i64,
        ]
        _lib = lib
        return lib


def _ids(seq, table: dict) -> np.ndarray:
    return np.asarray([table.setdefault(tok, len(table)) for tok in seq], np.int64)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def edit_distance_native(a: list, b: list) -> int:
    """Levenshtein distance of two token sequences. Tokens map to ids
    through one shared table, so the distance equals the pure-Python
    one (``train/metrics.py:edit_distance_py``) exactly."""
    lib = get_lib()
    table: dict = {}
    aa, bb = _ids(a, table), _ids(b, table)
    return int(lib.edit_distance_i64(_p64(aa), len(aa), _p64(bb), len(bb)))


def _pack(seqs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    flat = np.concatenate(seqs).astype(np.int64) if off[-1] else np.zeros(1, np.int64)
    return flat, off


def edit_distance_batch(pairs: list[tuple[list, list]], n_threads: int = 8) -> list[int]:
    """``edit_distance_native`` of every (a, b) pair, on ``n_threads``
    threads in one call."""
    lib = get_lib()
    table: dict = {}
    a_flat, a_off = _pack([_ids(a, table) for a, _ in pairs])
    b_flat, b_off = _pack([_ids(b, table) for _, b in pairs])
    out = np.zeros(len(pairs), np.int64)
    lib.edit_distance_batch_i64(_p64(a_flat), _p64(a_off), _p64(b_flat), _p64(b_off),
                                len(pairs), _p64(out), n_threads)
    return out.tolist()


def load_wav_batch_native(paths: list[str], max_samples: int, target_sr: int = 16000,
                          n_threads: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of WAV files into ([B, max_samples] f32 zero-padded,
    [B] int64 lengths): mono (channels averaged), linearly resampled to
    ``target_sr``, cut at ``max_samples``. ``lengths[i] == -1`` flags a
    file the decoder could not read."""
    lib = get_lib()
    flat = b"\0".join(os.fsencode(p) for p in paths) + b"\0"
    batch = np.zeros((len(paths), max_samples), np.float32)
    lengths = np.zeros(len(paths), np.int64)
    lib.load_wav_batch(flat, len(paths), max_samples, target_sr,
                       batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       _p64(lengths), n_threads)
    return batch, lengths
