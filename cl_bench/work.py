"""The yardstick's arithmetic: the card's peaks, each kernel's least work
(bytes and operations from the shapes the cell feeds it), the whole step's
and the whole pass's operations, and the device-op categories.

The kernel formulas are copies of the port's ``work`` functions
(``ops/flash_mhsa.py``, ``ops/rnnt_loss.py``, ``ops/decode_fused.py``),
kept here so that a change to the program cannot change the yardstick; a
CPU test holds them equal to the port's today.
"""

from __future__ import annotations

import math

import torch

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3


def bound_s(nbytes: float, flops: float) -> float:
    """Least time: the larger of bytes over peak bandwidth and operations
    over peak rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)


# ---- kernels

def _visible(T: int, lens) -> tuple[int, int, int]:
    """Unbanded attention: (rows with a visible pair, offsets j - t of
    visible pairs, visible pairs) for valid lengths ``lens``."""
    lens = [int(n) for n in lens]
    rows = sum(lens)
    longest = max(lens) if lens else 0
    return rows, (2 * longest - 1) if longest else 0, sum(n * n for n in lens)


def flash_forward(B: int, T: int, E: int, lens, itemsize: int = 2) -> tuple[int, int]:
    """q, k and v read over the rows within the lengths, p over the
    offsets of visible pairs, the two biases, out written in full; three
    dot products of length D per visible (query, key) pair."""
    rows, p_rows, visible = _visible(T, lens)
    nbytes = (3 * rows * E + p_rows * E + 2 * E + B * T * E) * itemsize
    return nbytes, 3 * 2 * visible * E


def flash_backward(B: int, T: int, E: int, lens, n_heads: int, itemsize: int = 2) -> tuple[int, int]:
    """q, k, v and dO over the rows within the lengths, p over the offsets,
    the biases and the f32 lse read; dq, dk, dv, dp and the bias gradients
    written; eight dot products of length D per visible pair."""
    rows, p_rows, visible = _visible(T, lens)
    nbytes = (4 * rows * E + p_rows * E + 2 * E) * itemsize + rows * n_heads * 4
    nbytes += (3 * B * T * E + (2 * T - 1) * E + 2 * E) * itemsize
    return nbytes, 8 * 2 * visible * E


def lattice(B: int, T: int, U1: int, beta: bool = False) -> tuple[int, int]:
    """One alpha (or beta) launch: the two f32 slabs read, the lattice
    written (T+1 rows for beta, plus the label lengths); per cell two adds
    and a logaddexp."""
    rows = T + 1 if beta else T
    nbytes = 2 * B * T * U1 * 4 + B * rows * U1 * 4 + (B * 4 if beta else 0)
    return nbytes, 8 * B * rows * U1


def greedy_decode(B: int, T: int, Hj: int, Hp: int, V1: int, joint_evals: int,
                  lstm_steps: int, n_langs: int = 1, itemsize: int = 2) -> tuple[int, int]:
    """One fused greedy launch: f_proj, the decode weights and the batch's
    language heads read once, ids and lengths written; a joint evaluation
    is [Hj] x [Hj, V1], an LSTM step two [Hp] x [Hp, 4Hp] products and the
    [Hp] x [Hp, Hj] projection."""
    weights = (V1 - 1) * Hp + 2 * Hp * 4 * Hp + 4 * Hp + Hp * Hj + Hj
    heads = n_langs * (Hj * V1 * itemsize + V1 * 4)
    nbytes = (B * T * Hj + weights) * itemsize + heads + 2 * B * 4 + 2 * B * 4
    flops = 2 * joint_evals * Hj * V1 + 2 * lstm_steps * (2 * Hp * 4 * Hp + Hp * Hj)
    return nbytes, flops


# ---- shapes

def mel_frames(samples: int, hop: int = 160) -> int:
    return samples // hop + 1


def encoder_frames(mel: int, m: dict) -> int:
    for _ in range(int(math.log2(m["subsampling_factor"]))):
        mel = (mel + 2 - 3) // 2 + 1
    return mel


def padded_frames(samples: int, m: dict, pad_to: int = 16) -> int:
    n = mel_frames(samples)
    return encoder_frames(n + (-n) % pad_to, m)


# ---- whole step and pass (operations, 2 per multiply-add)

def frontend_flops(B: int, S: int, fc: dict) -> int:
    frames = mel_frames(S, fc["hop_length"])
    n = fc["n_fft"]
    return B * frames * (int(2.5 * n * math.log2(n)) + 2 * (n // 2 + 1) * fc["n_mels"])


def encoder_flops(m: dict, B: int, S: int, lens) -> tuple[int, list[int], list[int]]:
    """(pre-encoder, [forward of each layer], [backward of each layer]) for
    a batch of padded length S samples and encoder lengths ``lens``."""
    d, dff, k = m["d_model"], m["d_model"] * m["ff_expansion_factor"], m["conv_kernel_size"]
    C = d if m["subsampling_conv_channels"] == -1 else m["subsampling_conv_channels"]
    T_mel = mel_frames(S)
    T_mel += (-T_mel) % 16
    Fq = m["feat_in"]
    pre, t, f, cin = 0, T_mel, Fq, 1
    for _ in range(int(math.log2(m["subsampling_factor"]))):
        t, f = (t + 2 - 3) // 2 + 1, (f + 2 - 3) // 2 + 1
        pre += 2 * B * t * f * C * cin * 9
        cin = C
    T = t
    pre += 2 * B * T * f * C * d
    dense = 2 * B * T * (2 * 2 * d * dff + 4 * d * d + 2 * d * d + d * d) + 2 * (2 * T - 1) * d * d
    dense += 2 * B * T * d * k
    fwd_att = flash_forward(B, T, d, lens)[1]
    bwd_att = flash_backward(B, T, d, lens, m["n_heads"])[1]
    L = m["n_layers"]
    return pre, [dense + fwd_att] * L, [2 * dense + bwd_att] * L


def train_step_flops(m: dict, tr: dict, fc: dict, B: int, S: int, lens, U1: int) -> int:
    """Forward of the whole step plus the backward of what trains, with no
    recomputation counted."""
    pre, fwd, bwd = encoder_flops(m, B, S, lens)
    T = padded_frames(S, m)
    d, Hp, Hj = m["d_model"], m["pred_hidden"], m["joint_hidden"]
    V1 = m["vocab_size_total"] // m["n_langs"] + 1
    lstm = m["pred_rnn_layers"] * 2 * B * U1 * (Hp + Hp) * 4 * Hp
    heads = 2 * B * T * d * Hj + 2 * B * U1 * Hp * Hj + 2 * B * T * d * V1
    joint = 2 * B * T * U1 * Hj * V1
    F_ = tr["freeze_encoder_till"]
    forward = frontend_flops(B, S, fc) + pre + sum(fwd) + lstm + heads + joint
    backward = sum(bwd[F_:]) + 2 * (lstm + heads + joint)
    return forward + backward


def eval_batch_flops(m: dict, fc: dict, B: int, S: int, lens, decoder: str,
                     joint_evals: int = 0, lstm_steps: int = 0) -> int:
    """One decode call: front end and encoder, then the joint projection
    and the emissions made (RNNT) or the CTC head."""
    pre, fwd, _ = encoder_flops(m, B, S, lens)
    T = padded_frames(S, m)
    d, Hp, Hj = m["d_model"], m["pred_hidden"], m["joint_hidden"]
    V1 = m["vocab_size_total"] // m["n_langs"] + 1
    out = frontend_flops(B, S, fc) + pre + sum(fwd)
    if decoder == "ctc":
        return out + 2 * B * T * d * V1
    return out + 2 * B * T * d * Hj + 2 * joint_evals * Hj * V1 \
        + 2 * lstm_steps * (2 * Hp * 4 * Hp + Hp * Hj)


# ---- device-op categories (the port's profile_step.category)

def category(name: str) -> str:
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copy/memset"
    for sub, what in (("flash_relpos_fwd", "flash_attention_forward"),
                      ("flash_relpos_bwd", "flash_attention_backward"),
                      ("bwd_finish_kernel", "flash_attention_backward"),
                      ("alpha_", "rnnt_lattice"), ("beta_", "rnnt_lattice"),
                      ("joint_", "fused_joint"),
                      ("rnnt_greedy_decode_kernel", "fused_greedy_decode"),
                      ("rnnt_beam_kernel", "fused_beam")):
        if sub in name:
            return what
    if any(s in low for s in ("lstm", "rnn_", "persist")):
        return "lstm"
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "conv", "winograd")):
        return "convolution"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas", "splitk", "gemv")):
        return "gemm"
    if any(s in low for s in ("copy", "fill")):
        return "copy/memset"
    if any(s in low for s in ("at::native", "elementwise", "reduce", "softmax", "norm",
                              "index", "scatter", "gather", "cat_", "where", "bn_")):
        return "elementwise/reduction"
    return "other"


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not ("memcpy" in low or "memset" in low)


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
