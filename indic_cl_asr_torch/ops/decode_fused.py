"""Fused greedy RNNT decode: one CUDA launch per batch + plain version.

Replaces the TPU kernel ``indic_cl_asr_tpu/ops/decode_fused_pallas.py:
rnnt_greedy_decode_fused`` (``pl.pallas_call`` at line 322, body
``_kernel`` at line 102): the whole frame-synchronous greedy decode
(joint, first-index argmax, emission, embedding, LSTM cell, pred-side
projection; all-blank rounds skip the LSTM) in one launch, with the same
contract: ``(ids [B, max_out] int32 blank-padded, lens [B] int32)``.

Greedy rows are independent, so the kernel (``csrc/decode_fused.cu``)
gives each batch row its own block, which walks its own frames and its
own emission loop with the head of its own language: a row never waits
for the others, and a batch may mix languages (the TPU kernel, one loop
over the whole batch, holds a single head). The embedding row is read
directly (no one-hot matmul). Every dot accumulates in f32 and is
rounded to the compute dtype where the model's ``pred_step`` /
``joint_step`` round, so f32 decoding is token-exact against the plain
version: ``ops/decoding.py:rnnt_greedy_decode`` over those steps.

What bounds it on the card: each LSTM step reads W_ih, W_hh and W_p
(about 7.3 MB in bf16 at flagship widths) from L2 into one SM, and steps
of a row run one after another, so the time is per-row latency (the L2
rate one SM can draw), far above the bytes bound of the whole launch.
Spreading a row over a cluster of blocks is the next step.

The joint activation is relu and the prediction net has one LSTM layer,
as in the flagship. The TPU kernel's VMEM budget (``decode_vmem_bytes`` /
``fits_fused_decode``) has no counterpart here: f_proj and the weights
stay in device memory and L2, and only the decode state lives in shared
memory. The card's own limit is the shared memory one block may use; the
launch asks for it with ``cudaFuncSetAttribute``, which fails over the
limit, and the wrapper raises on that error.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .decoding import rnnt_greedy_decode

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 640  # splits every flagship mat-vec evenly (csrc/decode_fused.cu)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _decode_params(model) -> list:
    pred, joint = model.prediction, model.joint
    lstm = pred.lstm[0]
    return [pred.embedding, lstm.w_ih, lstm.w_hh, lstm.bias, joint.pred.weight,
            joint.pred.bias, joint.head_kernel, joint.head_bias]


def extract_decode_weights(model) -> dict:
    """The kernel's operands from a HybridRNNTCTC (single LSTM layer), in
    the model's compute dtype and on its device: table [V, Hp] (the local token
    rows of the embedding), w_ih and w_hh [Hp, 4Hp], bias [4Hp], wp
    [Hp, Hj], bp [Hj], head [L, Hj, V1p] (every language's head, its
    V1 = V + 1 columns zero-padded to V1p, a multiple of 8, so each row is
    16-byte aligned for vector loads) and head_b [L, V1] f32.

    Cached on the model and made again only when one of these parameters
    is replaced or changed in place."""
    if len(model.prediction.lstm) != 1:
        raise ValueError("the fused decode takes a single LSTM layer")
    params = _decode_params(model)
    # inference tensors keep no version counter: their storage is the key
    key = tuple(
        (p.data_ptr(), 0 if p.is_inference() else p._version) for p in params
    )
    cached = getattr(model, "_decode_weights", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    emb, w_ih, w_hh, bias, wp, bp, head, head_b = params
    V1 = head.shape[-1]
    dt = model.cfg.dtype
    with torch.no_grad():
        w = {
            "table": emb[: V1 - 1].to(dt).contiguous(),
            "w_ih": w_ih.to(dt).contiguous(),
            "w_hh": w_hh.to(dt).contiguous(),
            "bias": bias.to(dt).contiguous(),
            "wp": wp.t().to(dt).contiguous(),
            "bp": bp.to(dt).contiguous(),
            "head": F.pad(head.to(dt), (0, _pad8(V1) - V1)).contiguous(),
            "head_b": head_b.float().contiguous(),
        }
    model._decode_weights = (key, w)
    return w


def rnnt_greedy_decode_fused_reference(
    f_proj, frame_lens, lang_ids, model, *, max_symbols: int = 10,
    max_out: int = 256,
):
    """Plain version of the kernel: the frame-sync decoder over the
    model's own ``pred_step`` / ``joint_step``."""
    return rnnt_greedy_decode(
        f_proj, frame_lens, lang_ids, model.pred_step, model.joint_step, None,
        blank=model.cfg.blank_local, max_symbols=max_symbols, max_out=max_out,
    )


# device-side counters of the work the kernel ran: [joint evaluations,
# LSTM steps], accumulated across launches (read with work_counts())
_work: dict[torch.device, torch.Tensor] = {}


def work_counts() -> dict[str, int]:
    """Joint evaluations and LSTM steps run by every launch since the last
    reset (synchronises with the card)."""
    tot = [0, 0]
    for t in _work.values():
        vals = t.tolist()
        tot[0] += int(vals[0])
        tot[1] += int(vals[1])
    return {"joint_evals": tot[0], "lstm_steps": tot[1]}


def reset_counts() -> None:
    rnnt_greedy_decode_fused.launches = 0
    for t in _work.values():
        t.zero_()


def rnnt_greedy_decode_fused(
    f_proj: torch.Tensor,      # [B, T, Hj] encoder-side joint projections
    frame_lens: torch.Tensor,  # [B]
    lang_ids: torch.Tensor,    # [B] language of each row
    model,                     # HybridRNNTCTC the projections came from
    *,
    max_symbols: int = 10,
    max_out: int = 256,
):
    """Fused greedy decode -> (ids [B, max_out] int32, lens [B] int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if f_proj.device.type == "cpu":
        return rnnt_greedy_decode_fused_reference(
            f_proj, frame_lens, lang_ids, model, max_symbols=max_symbols,
            max_out=max_out,
        )
    if f_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {f_proj.device}")
    w = extract_decode_weights(model)
    dt = w["table"].dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused decode takes float32 or bfloat16, got {dt}")
    B, T, Hj = f_proj.shape
    V, Hp = w["table"].shape
    L, V1 = w["head_b"].shape
    vec = 16 // (torch.finfo(dt).bits // 8)
    if Hp % vec or Hj % vec:
        raise ValueError(
            f"pred width {Hp} and joint width {Hj} must be multiples of {vec}"
        )
    dev = f_proj.device
    if w["table"].device != dev:
        raise ValueError(f"the model is on {w['table'].device}, f_proj on {dev}")
    f = f_proj.to(dt).contiguous()
    lens_i = frame_lens.to(device=dev, dtype=torch.int32).contiguous()
    lang_i = lang_ids.to(device=dev, dtype=torch.int32).contiguous()
    ids = torch.empty((B, max_out), dtype=torch.int32, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    work = _work.get(dev)
    if work is None:
        # a normal tensor even under inference mode, so reset_counts() may
        # zero it anywhere
        with torch.inference_mode(False):
            work = _work[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = _build.load("decode_fused")
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _build.ptr
    err = lib.rnnt_greedy_decode_fused(
        p(f), p(lens_i), p(lang_i), p(w["table"]), p(w["w_ih"]), p(w["w_hh"]),
        p(w["bias"]), p(w["wp"]), p(w["bp"]), p(w["head"]), p(w["head_b"]),
        p(ids), p(olen), p(work),
        B, T, Hj, Hp, V1, w["head"].shape[-1], L, V1 - 1, max_symbols,
        max_out, _DTYPES[dt], THREADS, ctypes.c_void_p(stream),
    )
    _build.check(lib, err, "rnnt_greedy_decode_fused")
    rnnt_greedy_decode_fused.launches += 1
    return ids, olen


rnnt_greedy_decode_fused.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rnnt_greedy_decode_fused.argtypes = [vp] * 14 + [i] * 12 + [vp]
    lib.rnnt_greedy_decode_fused.restype = i


_build.BINDERS["decode_fused"] = _bind


def work(B: int, T: int, Hj: int, Hp: int, V1: int, joint_evals: int,
         lstm_steps: int, n_langs: int = 1, itemsize: int = 2) -> tuple[int, int]:
    """(bytes, flops) for one launch with the given counted work: f_proj,
    the decode weights and the heads of the ``n_langs`` languages the batch
    holds read once, with frame and language ids; ids and lens written
    once. One joint evaluation is a [Hj] x [Hj, V1] product, one LSTM step
    two [Hp] x [Hp, 4Hp] products plus the [Hp] x [Hp, Hj] projection."""
    weights = (V1 - 1) * Hp + 2 * Hp * 4 * Hp + 4 * Hp + Hp * Hj + Hj
    heads = n_langs * (Hj * V1 * itemsize + V1 * 4)
    nbytes = (B * T * Hj + weights) * itemsize + heads + 2 * B * 4 + 2 * B * 4
    flops = 2 * joint_evals * Hj * V1 + 2 * lstm_steps * (2 * Hp * 4 * Hp + Hp * Hj)
    return nbytes, flops
