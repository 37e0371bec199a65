"""Fused RNNT beam search: one CUDA launch per batch + plain version.

Replaces the TPU kernel ``indic_cl_asr_tpu/ops/beam_fused_pallas.py:
rnnt_beam_search_fused`` (``pl.pallas_call`` at line 468, body ``_kernel``
at line 97): the whole frame-synchronous beam (expansion rounds, top-P and
top-K selection, parent gathers, LSTM steps, force-finalisation, in-beam
prefix merge, best of beam) in one launch, with the same contract:
``(ids [B, max_out] int32 blank-padded, lens [B] int32, scores [B] f32)``.

The kernel (``csrc/beam_fused.cu``) gives each batch row its own
thread-block cluster of ``CLUSTER`` blocks, as the greedy kernel does
(``ops/decode_fused.py``): the row walks its own frames and expansion
rounds with the head of its own language, so a batch may mix languages
(the TPU kernel holds one head for the whole batch). Each block streams
only its slice of the weights (``cluster_split``: all four gates of its
hidden units, its columns of W_p, its columns of the head), for all K
hypotheses at once: on the FMA units in f32, on the tensor cores in bf16
(``mma.sync``, every input of those products being a bf16 value, with the
weights transposed by ``beam_weights``). Every block holds the row's K
hypotheses (tokens, lengths, scores, h and g; the cell state by units)
and makes the same decisions: after the joint each block sends every peer
its partial log-softmax (max and sum of exponentials) and its top-P
(logit, index) per hypothesis, and every block merges them in rank order;
after the gates and after the projection each block sends its units' h
and its columns of g. Three cluster barriers a round that emits, one a
round that does not. A parent gather is an index into shared memory; the
TPU kernel's one-hot MXU gathers and layout products have no
counterpart. Its plain version is
``ops/beam_search.py:rnnt_beam_search_batched`` over the model's own
``pred_step`` / ``joint_step``, which equals the kernel row by row (the
kernel's source argues why a row may stop its rounds before the batch);
the log-softmax summed by blocks may move the last bits of a score, so in
f32 a row may differ only where the plain version's trace shows a tie.

What bounds it on the card: the rounds of a row run one after another,
so the time is the per-row chain of rounds: a round without an LSTM step
is a chain of short phases (the joint on the block's head slice, the
exchange and its barrier, the merge, the top-K, the gather), one with a
step adds the L2 draw of the block's 1/CLUSTER of W_ih, W_hh and W_p
(about 7.3 MB in bf16 at flagship widths over the cluster) and two more
barriers; both far above the bytes bound of the launch.

As for the greedy kernel: the joint activation is relu and the
prediction net has one LSTM layer. ``fits`` stands where the TPU kernel's
``fits_fused_beam`` does; its VMEM model has no counterpart: the card's
limit is the shared memory of one block (the replicated hypotheses, the
exchange slots, the partial sums), which the launch asks for with
``cudaFuncSetAttribute``, and the wrapper raises on its error.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, decode_fused
from .beam_search import rnnt_beam_search_batched
from .decode_fused import _DTYPES, cluster_split, extract_decode_weights

# 8 warps: one for each of up to 8 hypotheses; at 255 registers a thread
# the mat-vecs keep their sums of four hypotheses and eight rows of loads
# in flight without spilling (csrc/beam_fused.cu)
THREADS = 256
CLUSTER = 8  # blocks per row: the portable maximum of a thread-block cluster


def fits(beam_size: int, topk: int | None, V1: int, pred_hidden: int, joint_hidden: int,
         dtype: torch.dtype) -> bool:
    """Whether the kernel takes this search on a model of these widths: a
    beam of 1-8 (a warp a hypothesis), a top-K (``None``: the beam size) of
    1 to min(16, V+1) and the greedy kernel's widths
    (``decode_fused.fits``). The wrapper raises wherever this is false,
    and ``train/eval.py:resolve_decoders`` sends such a search to the
    batched beam, as the JAX package's ``fits_fused_beam`` does."""
    P = beam_size if topk is None else topk
    return (1 <= beam_size <= 8 and 1 <= P <= min(16, V1)
            and decode_fused.fits(pred_hidden, joint_hidden, dtype))


def rnnt_beam_search_fused_reference(
    f_proj, frame_lens, lang_ids, model, *, beam_size: int = 4,
    max_expansions: int = 6, max_out: int = 256, topk: int | None = None,
    trace: list | None = None,
):
    """Plain version of the kernel: the batched beam over the model's own
    ``pred_step`` / ``joint_step``."""
    return rnnt_beam_search_batched(
        f_proj, frame_lens, lang_ids, model.pred_step, model.joint_step, None,
        blank=model.cfg.blank_local, beam_size=beam_size,
        max_expansions=max_expansions, max_out=max_out, topk=topk, trace=trace,
    )


def beam_weights(model) -> dict:
    """The kernel's operands: ``extract_decode_weights``' in f32; in bf16
    the mat-vec weights transposed for the tensor cores (a row per output
    column, its depth contiguous): w_ih and w_hh [4Hp, Hp], wp [Hj, Hp],
    head [L, V1p, Hj]. Cached on the model beside the decode weights and
    made again with them."""
    w = extract_decode_weights(model)
    if w["table"].dtype != torch.bfloat16:
        return w
    cached = getattr(model, "_beam_weights", None)
    if cached is not None and cached[0] is w:
        return cached[1]
    with torch.no_grad():
        t = dict(w, w_ih=w["w_ih"].t().contiguous(), w_hh=w["w_hh"].t().contiguous(),
                 wp=w["wp"].t().contiguous(), head=w["head"].transpose(1, 2).contiguous())
    model._beam_weights = (w, t)
    return t


# device-side counters of the work the kernel ran: [joint evaluations of
# live hypotheses, LSTM steps of emitting hypotheses, expansion rounds],
# accumulated across launches (read with work_counts())
_work: dict[torch.device, torch.Tensor] = {}


def work_counts() -> dict[str, int]:
    """Joint evaluations, LSTM steps and expansion rounds run by every
    launch since the last reset (synchronises with the card)."""
    tot = [0, 0, 0]
    for t in _work.values():
        for i, v in enumerate(t.tolist()):
            tot[i] += int(v)
    return {"joint_evals": tot[0], "lstm_steps": tot[1], "rounds": tot[2]}


def reset_counts() -> None:
    rnnt_beam_search_fused.launches = 0
    for t in _work.values():
        t.zero_()


def rnnt_beam_search_fused(
    f_proj: torch.Tensor,      # [B, T, Hj] encoder-side joint projections
    frame_lens: torch.Tensor,  # [B]
    lang_ids: torch.Tensor,    # [B] language of each row
    model,                     # HybridRNNTCTC the projections came from
    *,
    beam_size: int = 4,
    max_expansions: int = 6,
    max_out: int = 256,
    topk: int | None = None,
):
    """Fused beam search -> (ids [B, max_out] int32, lens [B] int32,
    scores [B] f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if f_proj.device.type == "cpu":
        return rnnt_beam_search_fused_reference(
            f_proj, frame_lens, lang_ids, model, beam_size=beam_size,
            max_expansions=max_expansions, max_out=max_out, topk=topk,
        )
    if f_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {f_proj.device}")
    w = beam_weights(model)
    dt = w["table"].dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused beam takes float32 or bfloat16, got {dt}")
    B, T, Hj = f_proj.shape
    V, Hp = w["table"].shape
    L, V1 = w["head_b"].shape
    P = topk if topk is not None else beam_size
    if not fits(beam_size, topk, V1, Hp, Hj, dt):
        raise ValueError(
            f"fused beam takes beam_size 1-8, topk 1-min(16, V+1 = {V1}) and pred and "
            f"joint widths of whole 16-byte groups; got beam_size {beam_size}, topk {P}, "
            f"widths {Hp}, {Hj} in {dt}")
    vec = 16 // (torch.finfo(dt).bits // 8)
    dev = f_proj.device
    if w["table"].device != dev:
        raise ValueError(f"the model is on {w['table'].device}, f_proj on {dev}")
    f = f_proj.to(dt).contiguous()
    if f.data_ptr() % 16:  # the kernel reads each frame in 16-byte vectors
        f = f.clone()
    lens_i = frame_lens.to(device=dev, dtype=torch.int32).contiguous()
    lang_i = lang_ids.to(device=dev, dtype=torch.int32).contiguous()
    ids = torch.empty((B, max_out), dtype=torch.int32, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    oscore = torch.empty((B,), dtype=torch.float32, device=dev)
    work = _work.get(dev)
    if work is None:
        # a normal tensor even under inference mode, so reset_counts() may
        # zero it anywhere
        with torch.inference_mode(False):
            work = _work[dev] = torch.zeros(3, dtype=torch.int64, device=dev)
    V1p = decode_fused._pad8(V1)
    lib = _build.load("beam_fused")
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _build.ptr
    err = lib.rnnt_beam_search_fused(
        p(f), p(lens_i), p(lang_i), p(w["table"]), p(w["w_ih"]), p(w["w_hh"]),
        p(w["bias"]), p(w["wp"]), p(w["bp"]), p(w["head"]), p(w["head_b"]),
        p(ids), p(olen), p(oscore), p(work),
        B, T, Hj, Hp, V1, V1p, L, V1 - 1, beam_size, P,
        max_expansions, max_out, _DTYPES[dt], THREADS, CLUSTER, _bounds(Hp, Hj, V1p, vec),
        ctypes.c_void_p(stream),
    )
    _build.check(lib, err, "rnnt_beam_search_fused")
    rnnt_beam_search_fused.launches += 1
    return ids, olen, oscore


rnnt_beam_search_fused.launches = 0


def _bounds(Hp: int, Hj: int, V1p: int, vec: int):
    """cluster_split as the C array [3][CLUSTER + 1] the launch takes."""
    split = cluster_split(Hp, Hj, V1p, vec, CLUSTER)
    return (ctypes.c_int * (3 * (CLUSTER + 1)))(*split["unit"], *split["proj"], *split["head"])


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rnnt_beam_search_fused.argtypes = [vp] * 15 + [i] * 15 + [ctypes.POINTER(i), vp]
    lib.rnnt_beam_search_fused.restype = i


_build.BINDERS["beam_fused"] = _bind


def work(B: int, T: int, Hj: int, Hp: int, V1: int, joint_evals: int,
         lstm_steps: int, n_langs: int = 1, itemsize: int = 2) -> tuple[int, int]:
    """(bytes, flops) for one launch with the given counted work: the
    greedy kernel's accounting (``ops/decode_fused.py:work``: inputs read
    once, one [Hj] x [Hj, V1] product a joint evaluation, an LSTM step and
    its projection a step) plus the scores written."""
    nbytes, flops = decode_fused.work(B, T, Hj, Hp, V1, joint_evals, lstm_steps,
                                      n_langs=n_langs, itemsize=itemsize)
    return nbytes + B * 4, flops
