#!/usr/bin/env python3
"""Drive the PyTorch port (indic_cl_asr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script when it fails:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Build: compiles the five CUDA sources in indic_cl_asr_torch/csrc
   (flash_mhsa.cu: flash forward and backward; decode_fused.cu;
   rnnt_lattice.cu: alpha and beta; joint_fused.cu: the fused joint
   forward and backward; beam_fused.cu: the fused beam) with nvcc for
   sm_90a, one nvcc per source, started together; prints ptxas's
   registers, spills and shared memory, and the bf16 flash forward's and
   backward's dynamic shared memory a block (and the scalar backward's
   ptxas lines: f32, and bf16 at head dim 128).
3. Kernels against their plain PyTorch versions on the card:
   flash rel-pos attention at B16 T204 E512 H8 in f32 (max abs err
   <= 1e-4) and bf16 (<= 2e-2), plus T in {1, 37, 512}, a row with
   lens=0, a (16, 0) band, head dim 128 (E512 H4) and head dim 80 (run
   zero-padded to 128); the fused greedy decode (a cluster of
   blocks per row) at flagship widths
   (B16, T 204 and 300 in one language, and T 204 with the rows spread
   over the 12 languages; four draws each), token-exact in f32, and in
   bf16 at least 90% of the plain version's tokens reproduced before
   their row's first divergence (see check_decode for why tokens). The
   fused beam (a cluster of blocks per row; B16 K4 P4, max_expansions
   10, max_out 256) on the same
   cases plus a lens-0 row beside rows capped by max_out 16, and beam 1:
   in f32 ids and lens equal and scores within 1e-5·|score| in every row
   but those where the plain version's trace shows two competing
   candidates within 1e-5 of each other (counted and printed); in bf16
   the decode's token bar.
   The flash backward against autograd through the plain version on the
   same cases, with dropout 0 and 0.1 (the same bits on both sides): max
   error per gradient <= 1e-4·max|ref| in f32 and 2e-2·max|ref| in bf16;
   with a (0, 0) band in bf16 (dropout 0 and 0.1) the gradients of q, k,
   p and the biases exactly zero, which holds only if the backward
   rebuilds the forward's scores bit for bit, and dv within 2e-2·max|ref|;
   the kernels' dropout bits equal to the plain version's, keep rate
   within 5e-3 of 1 - rate; the alpha and beta lattices at B16 T204
   U+1 129 (rows with u_len 0, t_len 1, t_len < T; the warp kernels) and
   at B4 T64 U+1 600 (the block kernels): finite entries atol 1e-4, the
   same finite set, the NLL and both slab gradients rel 1e-5. A flash
   config at head dim 256 (d_model 512 in 2 heads, tiny otherwise): the
   eager attention route, no flash launch, the card's encoder output
   within 1e-4 of the CPU's in f32. The fused joint
   forward and backward at the flagship's B16 T204 U+1 129 H640 V+1 257
   (T not a multiple of the 8-frame tile, the rows' heads from two
   languages, a label outside the head) in f32 and bf16, dropout 0 and
   0.2, against the plain version with the same dropout bits: slabs atol
   1e-5 of the forward evaluated exactly (the plain version with an f64
   head; the f32 plain version's own sums are up to ~1e-5 off there), dW
   and db within 1e-5·max|ref|, df and dg within 1e-5·max|ref|
   in f32 and 1e-2·max|ref| in bf16 (both sides round one f32 sum to
   bf16; a bf16 step is 2^-8 of the value, and the kernels' f32 atomics
   sum in another order); the kernels' dropout bits equal the plain
   version's, keep rate within 2e-3 of 0.8.
4. The serving slice: 32 synthetic 16 kHz WAVs in two duration buckets,
   a char tokenizer trained here, the flagship model (17 layers, d512,
   bf16, flash attention; its encoder's attention route printed) with
   seeded random weights, transcribed with the
   RNNT and CTC decoders through ``Transcriber``. The launch counts are
   reset just before and read just after this run: flash launches must be
   17 x the encoder batches and decode launches the RNNT batches; three
   more passes of each decoder, in turns, give the spread of utts/s. Then
   the beam path, ``transcribe(entries, "rnnt_beam")`` (B16, beam 4,
   max_expansions 10, max_out 256) with its own counts reset and read:
   beam launches equal to the rnnt_beam batches, flash 17 x the encoder
   batches; and label-looping greedy, ``rnnt_beam_host`` and ``ctc_beam``
   on two short utterances each. Then the same model in f32, once through
   the kernels and once through the plain paths (eager attention,
   frame-sync decode, the batched beam): identical RNNT, CTC and rnnt_beam
   hypotheses, and label-looping greedy identical to both greedy paths.
5. Timing at the serving path's shapes (CUDA events): each kernel (the
   beam at the long bucket's batch), its plain version, and its bound (bytes over 3.35 TB/s or operations over
   the 989 TFLOP/s bf16 peak, whichever is larger). The flash forward,
   shorter than its wrapper's host time, is also timed by CUDA events
   over a CUDA graph of calls (``graph_ms``) and by its profiled device
   time (``device_ms``). Its
   yardstick (``library_ms``) is ``scaled_dot_product_attention`` with
   the position scores given (rounded, scaled, as its float attn_mask):
   not the same function, so it does not rank the kernel. The greedy decode's
   line also gives its cluster size, its block's shared memory, ptxas's
   registers and spills, and the longest row's rounds and LSTM steps.
6. The training slice: the flagship model (bf16, flash attention, layers
   0-11 frozen, the flagship dropouts, SpecAugment on) trained with
   ``make_train_step`` and AdamW (lr 1e-4, wd 0.01) on ``BatchPipeline``
   batches of 16 from the 4-8 s bucket (T 204, U 128), StepConfig as
   scripts/config.yaml sets it. The counts are reset just before the
   timed steps and read just after: per step 17 flash forwards, 5 flash
   backwards, 1 alpha and 1 beta. Every loss finite, the frozen parameters
   bit-unchanged, and a falling loss over 30 steps on one batch. Prints
   ms/step, utts/s, peak memory and one profiled step; then times the
   three training kernels at the inputs the step gave them, the flash
   backward and the lattices also over a CUDA graph of calls and by their
   profiled device time (the lattice lines name the kernel that ran), beside the backward of ``scaled_dot_product_attention`` with the
   position scores given (a yardstick, not the same function) and the
   atomic instructions a launch reaches (``flash_bwd_atomics``).
7. f32 equality of one step: flagship width at 4 layers (2 frozen), B4,
   attention dropout 0.1 (the kernel's bits), SpecAugment on (bands from
   the CPU generator), the other dropouts and dither off: the step on the
   card through the kernels against the same step on the CPU through the
   plain versions. Losses rel 1e-4, each gradient within 1e-3·max|grad|,
   BatchNorm statistics atol 1e-5, updated parameters atol 2·lr + 1e-6.
   Once with ``rnnt_impl="xla"`` and once with ``"pallas"`` (the fused
   joint kernels), at the same bars.
8. The continual-learning sequence: ``run_sequence`` at flagship width
   (17 layers, d512, bf16, layers 0-11 frozen, StepConfig(rnnt_impl=
   "pallas", rnnt_remat="none", uniform_lang_head=True)) over hindi then
   bengali (per language 32 training WAVs of 4.5-8 s, two batches of 16,
   and 8 WAVs each of val and test, clean and noisy), once for each of
   naive, EWC, MAS and LwF. The counts are reset just before and read
   just after each run: joint forward and backward = training steps +
   EWC importance batches, flash forward 17 x the encoder passes, flash
   backward 5 x the backward passes, alpha and beta = the RNNT losses,
   decode = the RNNT eval batches. After the four runs one eval batch of
   each shape goes through a new model of the same seed, outside the
   counted runs, and the flash forward is timed at layer 0's operands
   there (CUDA events, with its plain version and bound). Val matrix of one then two languages
   with finite WERs; on task 2 EWC's penalty_gnorm > 0, MAS's penalty > 0,
   LwF's rnnt_kd and ctc_kd finite and > 0; frozen parameters
   bit-unchanged; BatchNorm statistics bit-unchanged by every importance
   batch and by the LwF teacher's forwards; bwt_curves.json and
   model_<lang>.npz written. Then the peak memory of one step of a
   flagship batch under ``rnnt_impl="pallas"`` and ``"xla"``, ms per step
   (in turns), one profiled step of each (device-busy ms and idle share),
   and the joint kernels timed at the inputs that step gave them: the
   forward, the backward on the forward's inputs scratch (the training
   path) and on one it forms itself, their sum, each bound also at the
   TF32 rate of the split passes it runs, each launch's share of one
   profiled call, and ptxas's registers and spills for each kernel.

9. The command line: phase 8's WAVs written as manifests
   ({lang}_{train,val,test,noisy_val,noisy_test}.jsonl, hindi and
   bengali) and phase 8's tokenizer, padded to 256 pieces a language, as
   ``tokenizer_dir``; the model ``scripts/_common.py`` builds from the
   port's ``config.yaml`` with ``--n_langs 2`` (17 layers d512 in 8
   heads, bf16, flash attention, layers 0-11 frozen, B16, ``rnnt_impl``
   "xla") given phase 4's emitting weights and the BatchNorm statistics
   of a training batch, saved with ``save_model``;
   then ``cl_baseline.main`` from that ``--init_checkpoint`` with ``--lr
   1e-6`` (two tasks of two steps, the evals; at 1e-4 two Adam steps
   silence the random model, see ``run_cli``). Its counts are reset just before and read just
   after: flash forward 17 x (steps + eval batches), flash backward 5 x
   steps, alpha and beta = steps, decode = the RNNT eval batches (the
   batches counted from the manifests' durations). The losses finite,
   the frozen parameters bit-unchanged against the init checkpoint and
   absent from ``model_<lang>.npz``, both tasks in ``sequence/``. Then
   ``transcribe.main --run <run> --manifest <lang>_val.jsonl --wer`` for
   each language, greedy RNNT and ``--decoder ctc``, each with its counts:
   the printed WER equal to the WER the run logged last
   (``val/perf_<lang>_{rnnt,ctc}_wer``, rounded to 4 decimals as printed),
   the texts equal to the run's own last eval of that manifest, some
   hypotheses non-empty; then ``results.main``: every report PDF
   written and finite BWT values. Prints a ``cli: {...}`` line with the
   wall seconds of each part and the launches.
10. The pretrained path: phase 4's flagship (17 layers d512 in 8 heads,
   12 heads of 257 classes, its emitting weights) in f32, with the
   BatchNorm statistics of one of its data's batches and the blank biases
   calibrated after them, written as ``flagship.nemo`` (NeMo's
   model_config.yaml, the state dict under NeMo's names, twelve
   SentencePiece models of 256 pieces; ``write_nemo``, the inverse of
   models/pretrained.py's conversion); ``restore_pretrained`` on the card:
   every tensor bit-equal to the source's, the mapped config equal to the
   source's; ``transcribe.main --nemo`` with the RNNT and CTC decoders on
   phase 4's 32 WAVs as a manifest under the checkpoint's key "hi": texts
   equal to a ``Transcriber`` over the source model with the restored
   tokenizer, some non-empty; ``eval_pretrained.main`` on the same WAVs
   as the "hindi" test split with ``--n_langs 1 --local_tokenizer`` (the
   config's language names are not the checkpoint tokenizer's keys, as in
   the JAX package): records equal to the WER of a ``Transcriber`` over
   the source with that tokenizer. Each main's launches are reset just
   before and read just after: flash forward 17 x the encoded batches,
   greedy decode one per RNNT batch, every other kernel none. Prints the
   restore's seconds (config, read, convert, load, tokenizer), each
   main's seconds and the f32 flash forward's and greedy decode's ms a
   launch at the long bucket's batch (CUDA events; ``f32_ms`` in their
   kernel lines).
11. The streaming path at the flagship's width and depth: the model
   config.yaml gives with ``--n_langs 12 --mixed_precision false
   --model.causal_conv true --model.att_context_left 70
   --model.att_context_right 0`` (17 layers d512 in 8 heads, conv kernel
   31, x4, 257-wide heads, flash attention, f32), phase 4's emitting
   weights and blank calibration, on phase 4's 4.5-8 s bucket (B16, the
   mel zero-padded to a multiple of the 64-frame chunk). On every row's
   valid frames: ``stream_full_utterance_cached`` (chunk 64) and
   ``stream_full_utterance`` (chunk 64, window 1024 mel; 17 flash launches
   a window with the (70, 0) band) equal the offline ``encode`` within
   atol 2e-4 + rtol 1e-3; ``StreamingASR`` (``valid_mel`` on the last
   chunks) gives the fused greedy decode's offline tokens row for row; on
   a run dir saved for the model, ``stream_demo.main`` on two WAVs prints
   the texts ``transcribe.main`` gives offline. Launches are reset before
   and read after each part (the cache-aware step and ``stream_demo``
   launch no kernel; the offline yardstick and ``transcribe`` 17 flash and
   one decode). Prints the cache-aware step's ms a chunk at B1 and B16 and
   its real-time factor (a chunk is 0.64 s of audio), the windowed step's
   at B16, in f32 and bf16, and the phase's seconds (``streaming:`` line).
12. The host side: ``profile_step --steps 3`` (the flagship step's trace:
   the flash and lattice kernels among its rows, the categories summing to
   the device self time), ``flops_audit``: each kernel's FLOPs equal to its
   analytic work at the step's shapes times its launches in each program,
   ``bench_eval`` (labelsync, fused, beam, beam_fused at B16 x 8 s, 5
   batches), phase 8's training WAVs assembled in B16 batches by the native
   loader and by the Python reader in turns (byte-equal, ms a batch), and
   phase 9's transcripts' WER native against Python (equal).

Prints the card's name and power limit (``nvidia-smi``) on a line of its
own first, then the full record as one ``record {...}`` line, the
``{"kernels": [...]}`` line (each kernel's launches summed over the
counted runs of phases 4, 6 and 8-12, the beam's over its own path), and as
its last line ``{"ok": true,
"device": {...}}``; before them, the end-to-end numbers the fused joint
moves (the flagship CL step's wall and device-busy ms, idle share and
peak memory under each ``rnnt_impl``, CL wall time per method).
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # H100 SXM dense TF32 tensor-core peak
N_LAYERS = 17


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def cuda_ms(fn, iters=20, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn, iters=20):
    """ms a call of ``fn`` from CUDA events around one replay of a CUDA
    graph of ``iters`` calls: the launches run back to back with no host
    time between them, where a kernel shorter than its wrapper's host
    time makes ``cuda_ms`` measure the host."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel, calls=20):
    """The device time a call of ``fn`` spends in kernels whose name holds
    ``kernel`` (torch.profiler), over ``calls`` calls."""
    from indic_cl_asr_torch.utils.profiling import device_profile

    fn()
    kernels = device_profile(lambda: [fn() for _ in range(calls)], host=False)["kernels"]
    return sum(k["device_ms"] for k in kernels if kernel in k["name"]) / calls


def flash_timings(args, **kw):
    """The flash forward at ``args``, ms a call: CUDA events over eager
    calls (``ms``, as every kernel line is timed), over a CUDA graph of
    calls (``graph_ms``) and the kernel's profiled device time
    (``device_ms``). The biases and lengths are cast to the kernel's types
    first, so that the graph holds the kernel alone."""
    import torch

    from indic_cl_asr_torch.ops import flash_mhsa as fm

    q, k, v, p, u, vb, lens = args
    cast = (q, k, v, p, u.to(q.dtype), vb.to(q.dtype), lens.to(torch.int32))
    call = lambda: fm.flash_relpos_mhsa(*cast, **kw)
    return {"ms": cuda_ms(call), "graph_ms": cuda_graph_ms(call),
            "device_ms": device_ms(call, "flash_relpos_fwd")}


def flash_bwd_timings(args, **kw):
    """The flash backward at ``args`` (the wrapper's q, k, v, p, u, vb,
    lens, lse, dout as the caller gives them), ms a call: CUDA events over
    eager calls on ``args`` themselves (``ms``, as every kernel line: the
    casts a caller's operands need are part of the call) and, with the
    biases, lengths and cotangent cast to the kernel's types first, over
    eager calls (``ms_cast``), over a CUDA graph of calls (``graph_ms``,
    which then holds little beside the kernel) and profiled device time
    (``device_ms``)."""
    import torch

    from indic_cl_asr_torch.ops import flash_mhsa as fm

    q, k, v, p, u, vb, lens, lse, dout = args
    cast = (q, k, v, p, u.to(q.dtype), vb.to(q.dtype), lens.to(torch.int32), lse,
            dout.to(q.dtype).contiguous())
    call = lambda: fm.flash_relpos_mhsa_backward(*cast, **kw)
    return {"ms": cuda_ms(lambda: fm.flash_relpos_mhsa_backward(*args, **kw)),
            "ms_cast": cuda_ms(call), "graph_ms": cuda_graph_ms(call),
            "device_ms": device_ms(call, "flash_relpos_bwd")}


def bound_ms(nbytes: int, flops: int, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the flagship flash case's row lengths (B16 T204): full, ragged, 1 and 0
FLASH_LENS = [204] * 6 + [203, 190, 180, 160, 150, 120, 100, 64, 1, 0]


def flash_inputs(B, T, H, D, lens, dtype, dev, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    E = H * D
    q, k = (torch.randn((B, T, E), generator=g) for _ in range(2))
    v = 0.5 * torch.randn((B, T, E), generator=g)
    p = torch.randn((2 * T - 1, E), generator=g)
    u, vb = (0.1 * torch.randn((H, D), generator=g) for _ in range(2))
    ts = [t.to(dev, dtype) for t in (q, k, v, p, u, vb)]
    return ts + [torch.tensor(lens, dtype=torch.int32, device=dev)]


# phase 3's flash cases: (name, B, T, lens, band, heads, head dim); D 128
# (d_model 512 in 4 heads) and D 80, which runs zero-padded to 128
FLASH_CASES = [
    ("B16 T204 E512 H8", 16, 204, FLASH_LENS, (-1, -1), 8, 64),
    ("T1", 2, 1, [1, 0], (-1, -1), 8, 64),
    ("T37", 3, 37, [37, 20, 0], (-1, -1), 8, 64),
    ("T512", 2, 512, [512, 300], (-1, -1), 8, 64),
    ("band(16,0)", 4, 204, [204, 150, 17, 0], (16, 0), 8, 64),
    ("B4 T204 E512 H4 D128", 4, 204, [204, 150, 17, 0], (-1, -1), 4, 128),
    ("B3 T70 E320 H4 D80 padded", 3, 70, [70, 41, 0], (20, 10), 4, 80),
]


def check_flash(dev, rec):
    import torch

    from indic_cl_asr_torch.ops.flash_mhsa import (
        flash_relpos_mhsa,
        flash_relpos_mhsa_reference,
    )

    errs = {}
    for name, B, T, lens, (left, right), H, D in FLASH_CASES:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = flash_inputs(B, T, H, D, lens, dtype, dev, seed=T + B)
            out = flash_relpos_mhsa(*args, n_heads=H, left=left, right=right)
            ref = flash_relpos_mhsa_reference(*args, n_heads=H, left=left, right=right)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tag = f"{name} {str(dtype).split('.')[-1]}"
            errs[tag] = err
            log(f"  flash {tag}: max abs err {err:.3e} (tol {tol:g})")
            if not (err <= tol):
                raise AssertionError(f"flash {tag}: max abs err {err} > {tol}")
    rec["flash_errors"] = errs


def serving_weights_(model, seed, blank_bias=(0.0, 0.0)):
    """Seeded random weights for the serving checks, the same for every
    dtype and device: the residual-branch output projections scaled by 0.1
    (a deep random Conformer otherwise maps every frame to nearly the same
    vector), the heads scaled by 8 (so the top logits have margins), and
    the (RNNT, CTC) blank biases (see calibrate_blank_)."""
    import torch

    from indic_cl_asr_torch.models.hybrid import init_weights_

    init_weights_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for layer in model.encoder.layers:
            for lin in (layer.feed_forward1.linear2, layer.feed_forward2.linear2,
                        layer.self_attn.linear_out, layer.conv.pointwise_conv2):
                lin.weight.mul_(0.1)
        model.joint.head_kernel.mul_(8.0)
        model.ctc_decoder.kernel.mul_(8.0)
        model.joint.head_bias[:, -1] = blank_bias[0]
        model.ctc_decoder.bias[-1] = blank_bias[1]
    return model


def decode_blank_bias(model, f_proj, lens, lang, q):
    """The blank bias at which a fraction 1-q of the valid frames prefer a
    token over blank at the start of decoding, each row with its own
    language's head (the model's pred_step, then joint_step's arithmetic
    over all frames at once, without the blank's current bias)."""
    import torch

    from indic_cl_asr_torch.models.common import activate

    blank = model.cfg.blank_local
    B, T, _ = f_proj.shape
    with torch.inference_mode():
        g, _ = model.pred_step(torch.full((B,), blank, device=f_proj.device), None)
        x = activate(f_proj + g[:, None], model.cfg.joint_activation).float()
        lang = lang.long()
        logits = torch.einsum("bth,bhv->btv", x, model.joint.head_kernel[lang].float())
        logits = logits + model.joint.head_bias[lang].float()[:, None]
        blank_logit = logits[..., -1] - model.joint.head_bias[lang, -1].float()[:, None]
        margin = logits[..., :-1].amax(-1) - blank_logit
        valid = torch.arange(T, device=f_proj.device)[None] < lens[:, None]
        return float(torch.quantile(margin[valid], q))


def calibrate_blank_(model, batch, frontend):
    """Set the RNNT and CTC blank biases from one batch so that about 3%
    (RNNT, whose emissions come in runs fed back through the prediction
    net) and a quarter (CTC) of the frames prefer a token over blank at the
    start of decoding (a random model otherwise emits on every frame or on
    none).
    Returns the (RNNT, CTC) biases."""
    import torch

    from indic_cl_asr_torch.audio.features import log_mel_spectrogram

    dev = model.device
    with torch.inference_mode():
        mel, mel_lens = log_mel_spectrogram(
            torch.from_numpy(batch.audio).to(dev),
            torch.from_numpy(batch.audio_len).to(dev), frontend,
        )
        f, lens = model.encode(mel, mel_lens)
        lang = torch.from_numpy(batch.lang_ids).to(dev)
        B, T, _ = f.shape
        valid = torch.arange(T, device=dev)[None] < lens[:, None]
        f_proj = model.joint_project_enc(f)
        ctc = torch.einsum("btd,dv->btv", f.float(), model.ctc_decoder.kernel.float())
        V, L = model.cfg.vocab_per_lang, model.cfg.n_langs
        ctc_lang = ctc[..., :-1].reshape(B, T, L, V)[torch.arange(B), :, lang.long()]
        m_ctc = ctc_lang.amax(-1) - ctc[..., -1]
        biases = (decode_blank_bias(model, f_proj, lens, lang, 0.97),
                  float(torch.quantile(m_ctc[valid], 0.75)))
        model.joint.head_bias[:, -1] = biases[0]
        model.ctc_decoder.bias[-1] = biases[1]
    return biases


def check_decode(dev, rec, seeds=4):
    """Kernel against the frame-sync decoder over the model's own steps, at
    flagship widths: B16 at T 204 and 300 in one language and at T 204 over
    the 12 languages, each for ``seeds`` draws of f_proj and lengths, with
    each language's blank bias set so 3% of frames open an emission (the
    slice's calibration; emissions come in runs, 0.15-0.6 tokens a frame).

    f32 must be token-exact in every row. In bf16 the kernel sums each
    gate's products in another order than cuBLAS does; once a sum rounds to
    the other side of a bf16 step, that row's LSTM state differs and the
    rest of the row drifts. Such drift hits a correct kernel now and then
    (PERF.md gives the measured rate), so whole-row identity is a noisy
    bar: a batch of 16 with two drifted rows is common. The bf16 bar is on
    tokens instead: of the plain version's tokens, at least 90% must be
    reproduced before their row's first divergence, over all rows. A
    rounding fault would break rows within their first tokens and fall far
    below it. Rows identical and each drifted row's first divergent
    position are printed."""
    import torch

    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, flagship_config
    from indic_cl_asr_torch.ops.decode_fused import (
        rnnt_greedy_decode_fused,
        rnnt_greedy_decode_fused_reference,
    )

    cases = [("T204 lang 3", 204, False), ("T300 lang 3", 300, False),
             ("T204 12 langs", 204, True)]
    out, max_diff = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        model = HybridRNNTCTC(flagship_config(dtype, n_layers=1), device=dev)
        serving_weights_(model, seed=1)
        rows_same = rows_all = tokens = kept = 0
        firsts = []
        for name, T, mixed in cases:
            for seed in range(seeds):
                g = torch.Generator().manual_seed(1000 * seed + T)
                f_proj = torch.randn((16, T, 640), generator=g).to(dev, dtype)
                lens = torch.randint(T // 2, T + 1, (16,), generator=g).to(dev)
                lang = (torch.arange(16) % 12 if mixed else torch.full((16,), 3))
                lang = lang.to(device=dev, dtype=torch.int32)
                with torch.inference_mode():
                    for l in lang.unique().tolist():  # each language its own bias
                        r = lang == l
                        model.joint.head_bias[l, -1] = decode_blank_bias(
                            model, f_proj[r], lens[r], lang[r], 0.97)
                    ids, n = rnnt_greedy_decode_fused(f_proj, lens, lang, model)
                    ids_p, n_p = rnnt_greedy_decode_fused_reference(
                        f_proj, lens, lang, model)
                torch.cuda.synchronize()
                same = (ids == ids_p).all(dim=1) & (n == n_p)
                rows = int(same.sum())
                tag = f"B16 {name} seed {seed} {dname}"
                log(f"  decode {tag}: {rows}/16 rows identical, "
                    f"tokens per row {n_p.tolist()}")
                n_tok = int(n_p.sum())
                if n_tok == 0:
                    raise AssertionError(f"decode {tag}: no tokens emitted, nothing compared")
                lost = 0
                for r in (~same).nonzero().flatten().tolist():
                    diff = (ids[r] != ids_p[r]).nonzero().flatten()
                    first = int(diff[0]) if len(diff) else int(min(n[r], n_p[r]))
                    lost += max(int(n_p[r]) - first, 0)
                    firsts.append([first, int(n_p[r])])
                    log(f"    row {r}: first divergent position {first} "
                        f"(lens {int(n[r])} vs {int(n_p[r])})")
                rows_same, rows_all = rows_same + rows, rows_all + 16
                tokens, kept = tokens + n_tok, kept + n_tok - lost
                if dtype == torch.float32:
                    max_diff = max(max_diff, int((ids - ids_p).abs().max()))
                    if rows < 16:
                        raise AssertionError(f"decode {tag}: {rows}/16 rows identical in f32")
        share = kept / tokens
        out[dname] = {"rows_identical": rows_same, "rows": rows_all, "tokens": tokens,
                      "tokens_before_divergence": kept, "share": share,
                      "first_divergent_of_len": firsts}
        log(f"  decode {dname}: {rows_same}/{rows_all} rows identical; {kept} of "
            f"{tokens} plain tokens reproduced before their row's first "
            f"divergence ({share:.4f})")
        if share < 0.9:
            raise AssertionError(f"decode {dname}: token share {share:.4f} < 0.9")
        del model
    rec["decode_vs_plain"] = out
    rec["decode_f32_max_id_diff"] = max_diff


TIE_REL = 1e-5  # a summation-order tie: relative gap of two competing candidates


def check_beam(dev, rec, seeds=4):
    """The fused beam against its plain version (the batched beam over the
    model's own steps) at flagship widths, B16 K4 P4, max_expansions 10,
    max_out 256: T 204 and 300 in one language and T 204 over the 12
    languages, ``seeds`` draws each, with each language's blank bias set as
    check_decode sets it; then a row with lens 0 next to rows that hit a
    max_out of 16, and beam 1.

    f32: ids and lens equal in every row and scores within 1e-5·|score|.
    A row that differs passes only where the plain version's trace shows a
    decision between two candidates within TIE_REL of each other (the
    kernel sums in another order than cuBLAS); such rows are counted and
    printed. bf16: the check_decode token bar (at least 90% of the plain
    version's tokens reproduced before their row's first divergence)."""
    import torch

    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, flagship_config
    from indic_cl_asr_torch.ops.beam_fused import (
        rnnt_beam_search_fused,
        rnnt_beam_search_fused_reference,
    )

    K = dict(beam_size=4, max_expansions=10, max_out=256)
    cases = [(f"T{T} {name}", T, mixed, K, False) for name, T, mixed in
             (("lang 3", 204, False), ("lang 3", 300, False), ("12 langs", 204, True))
             for _ in range(seeds)]
    cases += [("T204 lens 0, max_out 16", 204, False, dict(K, max_out=16), True),
              ("T204 beam 1", 204, False, dict(K, beam_size=1), False)]
    out = {}
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        model = HybridRNNTCTC(flagship_config(dtype, n_layers=1), device=dev)
        serving_weights_(model, seed=1)
        rows_same = rows_all = tokens = kept = 0
        ties, firsts = [], []
        for i, (name, T, mixed, kw, lens0) in enumerate(cases):
            g = torch.Generator().manual_seed(1000 * i + T)
            f_proj = torch.randn((16, T, 640), generator=g).to(dev, dtype)
            lens = torch.randint(T // 2, T + 1, (16,), generator=g)
            if lens0:
                lens[1] = 0
            lens = lens.to(dev)
            lang = (torch.arange(16) % 12 if mixed else torch.full((16,), 3))
            lang = lang.to(device=dev, dtype=torch.int32)
            trace = []
            with torch.inference_mode():
                for l in lang.unique().tolist():  # each language its own bias
                    r = lang == l
                    model.joint.head_bias[l, -1] = decode_blank_bias(
                        model, f_proj[r], lens[r], lang[r], 0.97)
                ids, n, sc = rnnt_beam_search_fused(f_proj, lens, lang, model, **kw)
                ids_p, n_p, sc_p = rnnt_beam_search_fused_reference(
                    f_proj, lens, lang, model, trace=trace, **kw)
            torch.cuda.synchronize()
            same = (ids == ids_p).all(dim=1) & (n == n_p)
            gap = torch.stack(trace).amin(dim=0) if trace else torch.full_like(sc_p, math.inf)
            tag = f"B16 {name} draw {i} {dname}"
            n_tok = int(n_p.sum())
            log(f"  beam {tag}: {int(same.sum())}/16 rows identical, tokens per row "
                f"{n_p.tolist()}")
            if n_tok == 0:
                raise AssertionError(f"beam {tag}: no tokens emitted, nothing compared")
            if lens0 and (int(n[1]) != 0 or int((n_p == 16).sum()) == 0):
                raise AssertionError(f"beam {tag}: lens-0 row or max_out cap not exercised")
            lost = 0
            for r in (~same).nonzero().flatten().tolist():
                diff = (ids[r] != ids_p[r]).nonzero().flatten()
                first = int(diff[0]) if len(diff) else int(min(n[r], n_p[r]))
                lost += max(int(n_p[r]) - first, 0)
                firsts.append([first, int(n_p[r])])
                tie = float(gap[r]) <= TIE_REL
                log(f"    row {r}: first divergent position {first} (lens {int(n[r])} vs "
                    f"{int(n_p[r])}), plain's smallest decision gap {float(gap[r]):.3e}"
                    f"{' (a tie)' if tie else ''}")
                if dtype == torch.float32:
                    if not tie:
                        raise AssertionError(f"beam {tag} row {r}: differs in f32 without a tie")
                    ties.append({"case": tag, "row": r, "gap": float(gap[r])})
            if dtype == torch.float32:
                err = ((sc - sc_p).abs() / sc_p.abs().clamp(min=1.0))[same]
                e = float(err.max()) if len(err) else 0.0
                max_err = max(max_err, float((sc - sc_p).abs()[same].max()) if len(err) else 0.0)
                if e > 1e-5:
                    raise AssertionError(f"beam {tag}: score rel err {e} > 1e-5")
            rows_same, rows_all = rows_same + int(same.sum()), rows_all + 16
            tokens, kept = tokens + n_tok, kept + n_tok - lost
        share = kept / tokens
        out[dname] = {"rows_identical": rows_same, "rows": rows_all, "tokens": tokens,
                      "tokens_before_divergence": kept, "share": share,
                      "first_divergent_of_len": firsts, "f32_ties": ties}
        log(f"  beam {dname}: {rows_same}/{rows_all} rows identical; {kept} of {tokens} "
            f"plain tokens reproduced before their row's first divergence ({share:.4f})"
            + (f"; {len(ties)} rows differ at a summation-order tie" if dtype == torch.float32
               else ""))
        if share < 0.9:
            raise AssertionError(f"beam {dname}: token share {share:.4f} < 0.9")
        del model
    rec["beam_vs_plain"] = out
    rec["beam_f32_max_abs_score_err"] = max_err


WORDS = {"hindi": ["namaste", "dhanyavad", "pani", "ghar", "samay", "kal", "aaj"],
         "bengali": ["nomoshkar", "dhonnobad", "jol", "bari", "shomoy", "kal", "aj"]}


def make_data(root, n=32, seed=0, lang="hindi", durations=((2.5, 4.0), (4.5, 8.0)),
              noise=0.05, prefix="utt"):
    """``n`` WAVs of one language, the i-th of a duration drawn from
    ``durations[i % len(durations)]`` (by default two buckets, 2.5-4 s and
    4.5-8 s), a tone plus white noise of std ``noise``."""
    import numpy as np

    from indic_cl_asr_torch.audio.io import write_wav
    from indic_cl_asr_torch.data.manifest import ManifestEntry

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    words = WORDS[lang]
    entries = []
    for i in range(n):
        lo, hi = durations[i % len(durations)]
        dur = float(rng.uniform(lo, hi))
        samples = int(dur * 16000)
        t = np.arange(samples) / 16000.0
        f0 = rng.uniform(100, 300)
        wav = 0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
        wav = (wav + noise * rng.standard_normal(samples)).astype(np.float32)
        path = os.path.join(root, f"{prefix}_{i:02d}.wav")
        write_wav(path, wav, 16000)
        text = " ".join(rng.choice(words, size=int(rng.integers(2, 6))))
        entries.append(ManifestEntry(audio_filepath=path, duration=dur, text=text, lang=lang))
    return entries, words


def run_slice(dev, rec):
    import torch

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.audio.io import load_audio
    from indic_cl_asr_torch.data.pipeline import BucketSpec, _assemble
    from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer
    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, flagship_config
    from indic_cl_asr_torch.ops.decode_fused import reset_counts, rnnt_greedy_decode_fused, work_counts
    from indic_cl_asr_torch.ops.flash_mhsa import flash_relpos_mhsa
    from indic_cl_asr_torch.train.eval import Transcriber

    entries, words = make_data(os.path.join(ROOT, "build", "chip_smoke", "wavs"))
    langs = ["hindi"] + [f"lang{i}" for i in range(1, 12)]
    corpus = [" ".join(words)] * 4
    tok = MultilingualTokenizer({l: CharTokenizer.train(corpus) for l in langs})
    spec = BucketSpec(boundaries_sec=(4.0, 8.0), max_tokens=(64, 128))

    def transcriber(model, **kw):
        return Transcriber(model=model, tokenizer=tok, languages=langs,
                           frontend=FrontendConfig(), batch_size=16,
                           bucket_spec=spec, **kw)

    model = HybridRNNTCTC(flagship_config(torch.bfloat16, attn_impl="flash"), device=dev)
    rec["attention_route"] = model.encoder.attention_route
    log(f"  flagship encoder attention route: {rec['attention_route']!r}")
    serving_weights_(model, seed=0)
    tr = transcriber(model, greedy_impl="fused")
    long = [e for e in entries if spec.bucket_of(e.duration) == 1][:16]
    long_batch = _assemble(long, len(long), 1, spec, tok,
                           {l: i for i, l in enumerate(langs)}, 0, load_audio, None)
    biases = calibrate_blank_(model, long_batch, tr.frontend)
    rec["blank_biases"] = biases
    log(f"  blank biases (RNNT, CTC): {biases}")
    tr.transcribe(entries, "rnnt")  # warm-up: cuBLAS/cuDNN handles, kernel loads
    tr.transcribe(entries, "ctc")

    # --- the main path: counts reset just before, read just after ---
    tr.counts.clear()
    flash_relpos_mhsa.launches = 0
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = {"rnnt": tr.transcribe(entries, "rnnt")}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hyps["ctc"] = tr.transcribe(entries, "ctc")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {
        "flash_relpos_mhsa": flash_relpos_mhsa.launches,
        "rnnt_greedy_decode_fused": rnnt_greedy_decode_fused.launches,
    }
    counts = dict(tr.counts)
    decode_work = work_counts()
    log(f"  launches {launches}, batches {counts}, decode work {decode_work}")
    if launches["flash_relpos_mhsa"] != N_LAYERS * counts["encoder_batches"]:
        raise AssertionError("flash launches != 17 x encoder batches")
    if launches["rnnt_greedy_decode_fused"] != counts["rnnt_batches"]:
        raise AssertionError("decode launches != rnnt batches")
    for d in ("rnnt", "ctc"):
        h = hyps[d]
        if len(h) != len(entries) or not all(isinstance(s, str) for s in h):
            raise AssertionError(f"{d}: malformed hypotheses")
        if not any(h):
            raise AssertionError(f"{d}: every hypothesis is empty")
    n_b = counts["rnnt_batches"]
    rec["slice_bf16"] = {
        "utterances": len(entries),
        "batches_per_decoder": n_b,
        "rnnt_s": t1 - t0, "ctc_s": t2 - t1,
        "rnnt_utts_per_s": len(entries) / (t1 - t0),
        "ctc_utts_per_s": len(entries) / (t2 - t1),
        "rnnt_ms_per_batch": (t1 - t0) * 1e3 / n_b,
        "ctc_ms_per_batch": (t2 - t1) * 1e3 / n_b,
        "launches": launches, "decode_work": decode_work,
        "example_rnnt": hyps["rnnt"][0][:80], "example_ctc": hyps["ctc"][0][:80],
    }
    log(f"  bf16 slice: rnnt {rec['slice_bf16']['rnnt_utts_per_s']:.2f} utts/s "
        f"({rec['slice_bf16']['rnnt_ms_per_batch']:.2f} ms/batch), ctc "
        f"{rec['slice_bf16']['ctc_utts_per_s']:.2f} utts/s "
        f"({rec['slice_bf16']['ctc_ms_per_batch']:.2f} ms/batch)")
    # one pass is host-bound and its wall time spreads from run to run:
    # three more passes of each decoder, in turns, outside the counted run
    reps = {"rnnt": [], "ctc": []}
    for _ in range(3):
        for d in reps:
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.transcribe(entries, d)
            torch.cuda.synchronize()
            reps[d].append(len(entries) / (time.perf_counter() - t))
    rec["slice_bf16"]["utts_per_s_more_passes"] = reps
    log(f"  bf16 slice, three more passes in turns: rnnt "
        f"{[round(v, 2) for v in reps['rnnt']]} utts/s, ctc "
        f"{[round(v, 2) for v in reps['ctc']]} utts/s")
    rec["profile_rnnt"] = profile_pass(tr, entries, (t1 - t0) * 1e3)
    enc_inputs = capture_main_path_inputs(model, tr.frontend, long_batch)
    launches = {**launches, **run_beam_path(tr, entries, rec)}
    short = [e for e in entries if spec.bucket_of(e.duration) == 0][:2]
    side = {"labelsync": transcriber(model, greedy_impl="labelsync").transcribe(short, "rnnt"),
            "rnnt_beam_host": tr.transcribe(short, "rnnt_beam_host"),
            "ctc_beam": tr.transcribe(short, "ctc_beam")}
    for d, h in side.items():
        if len(h) != 2 or not all(isinstance(s, str) for s in h):
            raise AssertionError(f"{d}: malformed hypotheses")
    log(f"  bf16 on two short utterances: {side}")
    rec["side_decoders_bf16"] = side

    # --- f32: through the kernels, and through the plain paths ---
    f32 = {}
    decoders = ("rnnt", "ctc", "rnnt_beam")
    for name, attn, greedy, beam in (("kernels", "flash", "fused", "fused"),
                                     ("plain", "xla", "framesync", "xla")):
        m = HybridRNNTCTC(flagship_config(torch.float32, attn_impl=attn), device=dev)
        serving_weights_(m, seed=0, blank_bias=biases)
        t = transcriber(m, greedy_impl=greedy, beam_impl=beam)
        f32[name] = {d: t.transcribe(entries, d) for d in decoders}
        if name == "plain":
            f32["labelsync"] = {"rnnt": transcriber(m, greedy_impl="labelsync").transcribe(
                entries, "rnnt")}
        del m, t
        torch.cuda.empty_cache()
    pairs = [(d, "kernels", "plain") for d in decoders]
    pairs += [("rnnt", "labelsync", "plain"), ("rnnt", "labelsync", "kernels")]
    for d, x, y in pairs:
        a, b = f32[x][d], f32[y][d]
        bad = [i for i in range(len(a)) if a[i] != b[i]]
        log(f"  f32 {d}: {len(a) - len(bad)}/{len(a)} hypotheses identical ({x} vs {y})")
        if bad:
            i = bad[0]
            raise AssertionError(f"f32 {d} utt {i}: {a[i]!r} != {b[i]!r} ({x} vs {y})")
    rec["slice_f32_identical"] = True
    return enc_inputs, launches, decode_work, (entries, tok, langs)


def run_beam_path(tr, entries, rec):
    """The slice's beam path: ``transcribe(entries, "rnnt_beam")`` through
    the fused beam kernel, with the counts reset just before and read just
    after. Returns its launches."""
    import torch

    from indic_cl_asr_torch.ops import beam_fused as bfm
    from indic_cl_asr_torch.ops.flash_mhsa import flash_relpos_mhsa

    tr.transcribe(entries, "rnnt_beam")  # warm-up
    tr.counts.clear()
    flash_relpos_mhsa.launches = 0
    bfm.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = tr.transcribe(entries, "rnnt_beam")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rnnt_beam_search_fused": bfm.rnnt_beam_search_fused.launches}
    counts = dict(tr.counts)
    work = bfm.work_counts()
    log(f"  rnnt_beam: launches {launches}, flash {flash_relpos_mhsa.launches}, batches "
        f"{counts}, beam work {work}")
    if launches["rnnt_beam_search_fused"] != counts["rnnt_beam_batches"]:
        raise AssertionError("beam launches != rnnt_beam batches")
    if flash_relpos_mhsa.launches != N_LAYERS * counts["encoder_batches"]:
        raise AssertionError("flash launches != 17 x encoder batches on the beam path")
    if len(hyps) != len(entries) or not all(isinstance(s, str) for s in hyps) or not any(hyps):
        raise AssertionError("rnnt_beam: malformed or all-empty hypotheses")
    n_b = counts["rnnt_beam_batches"]
    rec["slice_bf16_beam"] = {
        "utterances": len(entries), "batches": n_b, "s": wall,
        "utts_per_s": len(entries) / wall, "ms_per_batch": wall * 1e3 / n_b,
        "launches": launches, "work": work, "example": hyps[0][:80],
    }
    log(f"  bf16 slice: rnnt_beam {len(entries) / wall:.2f} utts/s "
        f"({wall * 1e3 / n_b:.2f} ms/batch)")
    rec["profile_rnnt_beam"] = profile_pass(tr, entries, wall * 1e3, decoder="rnnt_beam")
    return launches


def profile_pass(tr, entries, wall_ms, top=12, decoder="rnnt"):
    """torch.profiler over one pass of the slice through ``decoder`` (after
    the counted run): device-busy time (the sum of the kernels' and copies' device
    times on the one stream, against ``wall_ms``, the same pass timed
    without the profiler) and the kernels that take the most of it."""
    from indic_cl_asr_torch.utils.profiling import device_profile

    prof = device_profile(lambda: tr.transcribe(entries, decoder), top)
    busy_ms = prof["device_busy_ms"]
    rows = [dict(r, name=r["name"][:90]) for r in prof["top"]]
    log(f"  profile (one {decoder} pass, {len(entries)} utts): device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall unprofiled "
        f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for r in rows:
        log(f"    {r['device_ms']:9.3f} ms  {r['calls']:6d}x  {r['name']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "top": rows}


def capture_main_path_inputs(model, frontend, batch):
    """The inputs the main path gives each kernel for the long (8 s)
    bucket's batch: layer 0's attention operands, and the batch's f_proj
    and languages with the model they came from."""
    import torch

    from indic_cl_asr_torch.audio.features import log_mel_spectrogram

    dev = model.device
    seen = {}

    def hook(mod, args):
        x, pos_emb, lens = args[:3]
        seen["args"] = (mod.linear_q(x), mod.linear_k(x), mod.linear_v(x),
                        mod.linear_pos(pos_emb), mod.pos_bias_u, mod.pos_bias_v, lens)

    attn = model.encoder.layers[0].self_attn
    handle = attn.register_forward_pre_hook(hook)
    with torch.inference_mode():
        mel, mel_lens = log_mel_spectrogram(
            torch.from_numpy(batch.audio).to(dev),
            torch.from_numpy(batch.audio_len).to(dev), frontend,
        )
        f, enc_lens = model.encode(mel, mel_lens)
        f_proj = model.joint_project_enc(f)
    handle.remove()
    assert torch.isfinite(f.float()).all() and f.shape[0] == 16
    return {"flash": seen["args"], "f_proj": f_proj, "enc_lens": enc_lens,
            "lang": torch.from_numpy(batch.lang_ids).to(dev), "model": model}


def time_kernels(model_inputs, launches, decode_work_main, rec):
    import torch

    from indic_cl_asr_torch.ops import decode_fused as dfm
    from indic_cl_asr_torch.ops import flash_mhsa as fm

    lines = []
    q, k, v, p, u, vb, lens = model_inputs["flash"]
    B, T, E = q.shape
    kw = dict(n_heads=8)
    with torch.inference_mode():
        out = fm.flash_relpos_mhsa(q, k, v, p, u, vb, lens, **kw)
        ref = fm.flash_relpos_mhsa_reference(q, k, v, p, u, vb, lens, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        times = flash_timings((q, k, v, p, u, vb, lens), **kw)
        ms = times["ms"]
        plain = cuda_ms(lambda: fm.flash_relpos_mhsa_reference(q, k, v, p, u, vb, lens, **kw))
    rec["flash_forward_serving"] = times
    nbytes, flops = fm.work(B, T, E, lens.cpu(), itemsize=2)
    b_ms, b_by = bound_ms(nbytes, flops)
    sdpa_ms = time_sdpa_yardstick(q, k, v, p, u, vb, lens, n_heads=8)
    rec["flash_library_ms_is"] = ("scaled_dot_product_attention, position scores given: "
                                  "the rounded, scaled rel-shift scores passed as its "
                                  "float attn_mask (not the same function)")
    lines.append({
        "name": "flash_relpos_mhsa", "route": "cuda",
        "source": "indic_cl_asr_torch/csrc/flash_mhsa.cu",
        "replaces": "indic_cl_asr_tpu/ops/flash_mhsa.py:383",
        "launches": launches["flash_relpos_mhsa"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": sdpa_ms, "graph_ms": times["graph_ms"], "device_ms": times["device_ms"],
    })
    log(f"  flash B{B} T{T} E{E} bf16: {ms:.4f} ms (CUDA events over eager calls; over a "
        f"graph of calls {times['graph_ms']:.4f}, profiled device time "
        f"{times['device_ms']:.4f}), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{nbytes} B, {flops} flop), err {err:.3e}; SDPA with the position scores "
        f"given {sdpa_ms:.4f} ms")

    f_proj, enc_lens = model_inputs["f_proj"], model_inputs["enc_lens"]
    dargs = (f_proj, enc_lens, model_inputs["lang"], model_inputs["model"])
    with torch.inference_mode():
        ids, n = dfm.rnnt_greedy_decode_fused(*dargs)
        ids_p, n_p = dfm.rnnt_greedy_decode_fused_reference(*dargs)
        rows = int(((ids == ids_p).all(dim=1) & (n == n_p)).sum())
        dfm.reset_counts()
        ms = cuda_ms(lambda: dfm.rnnt_greedy_decode_fused(*dargs), iters=5, warmup=0)
        # sums over the 5 launches; the longest row's chain is the same in each
        work_each = {k_: v_ // 5 if k_ in ("joint_evals", "lstm_steps") else v_
                     for k_, v_ in dfm.work_counts().items()}
        plain = cuda_ms(lambda: dfm.rnnt_greedy_decode_fused_reference(*dargs),
                        iters=2, warmup=1)
        # the same batch with its rows spread over the 12 languages' heads
        mixed = (torch.arange(len(enc_lens), device=f_proj.device) % 12).to(torch.int32)
        margs = (f_proj, enc_lens, mixed, model_inputs["model"])
        ms_mixed = cuda_ms(lambda: dfm.rnnt_greedy_decode_fused(*margs), iters=5, warmup=1)
        plain_mixed = cuda_ms(lambda: dfm.rnnt_greedy_decode_fused_reference(*margs),
                              iters=2, warmup=1)
        dfm.reset_counts()
        n_mixed = dfm.rnnt_greedy_decode_fused(*margs)[1]
        work_mixed = dfm.work_counts()
    # the blank biases were calibrated on the batch's own language, so other
    # heads emit more; a launch lasts as long as its longest row's chain
    rec["decode_mixed_lang"] = {"ms": ms_mixed, "plain_ms": plain_mixed,
                                "tokens": n_mixed.tolist(), "work": work_mixed}
    log(f"  decode, rows over 12 languages: {ms_mixed:.4f} ms, plain "
        f"{plain_mixed:.4f} ms, tokens {n_mixed.tolist()}, work {work_mixed}")
    B, T, Hj = f_proj.shape
    n_langs = int(model_inputs["lang"].unique().numel())
    nbytes, flops = dfm.work(B, T, Hj, 640, 257, work_each["joint_evals"],
                             work_each["lstm_steps"], n_langs=n_langs, itemsize=2)
    b_ms, b_by = bound_ms(nbytes, flops)
    lines.append({
        "name": "rnnt_greedy_decode_fused", "route": "cuda",
        "source": "indic_cl_asr_torch/csrc/decode_fused.cu",
        "replaces": "indic_cl_asr_tpu/ops/decode_fused_pallas.py:322",
        "launches": launches["rnnt_greedy_decode_fused"],
        # largest token-id difference in the f32 comparison (phase 3)
        "max_abs_err": rec["decode_f32_max_id_diff"],
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })
    layout = {"cluster": dfm.CLUSTER, "threads": dfm.THREADS,
              "shared_bytes_per_block": dfm.shared_memory_bytes(model_inputs["model"]),
              "ptxas": ptxas_lines("decode_fused", "rnnt_greedy_decode_kernel")}
    log(f"  decode B{B} T{T} bf16: {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {nbytes} B, {flops} flop), work {work_each}, "
        f"tokens {n.tolist()}, bf16 rows identical to plain {rows}/{B}; a cluster of "
        f"{layout['cluster']} blocks of {layout['threads']} threads a row, "
        f"{layout['shared_bytes_per_block']} B of shared memory a block, ptxas "
        f"{layout['ptxas']}; the longest row {work_each['row_joint_evals_max']} rounds "
        f"(joint evaluations), {work_each['row_lstm_steps_max']} LSTM steps")
    rec["decode_bf16_main_rows_identical"] = rows
    rec["decode_work_per_launch"] = work_each
    rec["decode_work_main_path"] = decode_work_main
    rec["decode_layout"] = layout
    lines.append(time_beam(model_inputs, launches, rec))
    return lines


def time_sdpa_yardstick(q, k, v, p, u, vb, lens, n_heads):
    """ms of one ``scaled_dot_product_attention`` call on the same heads
    with the position scores given: the rel-shift scores, rounded to the
    compute dtype and scaled, and -1e30 where masked, as its float
    attn_mask. Not the same function (the kernel computes those scores
    itself); a yardstick for ``library_ms`` only, never called by the port."""
    import torch
    import torch.nn.functional as F

    from indic_cl_asr_torch.ops import flash_mhsa as fm

    B, T, E = q.shape
    H, D = n_heads, E // n_heads
    heads = lambda x: x.reshape(B, T, H, D).transpose(1, 2).contiguous()
    with torch.inference_mode():
        qu = heads(q + u.reshape(-1).to(q.dtype))
        qv = heads(q + vb.reshape(-1).to(q.dtype))
        raw = torch.einsum("bhtd,phd->bhtp", qv.float(), p.reshape(-1, H, D).float())
        t_idx = torch.arange(T, device=q.device)
        shift = (T - 1) + t_idx[None, :] - t_idx[:, None]
        bd = torch.gather(raw, 3, shift.expand(B, H, T, T)).to(q.dtype).float()
        mask = fm._mask(T, lens.to(torch.int64), -1, -1)
        bias = torch.where(mask, bd / math.sqrt(D), -1e30).to(q.dtype)
        kh, vh = heads(k), heads(v)
        return cuda_ms(lambda: F.scaled_dot_product_attention(qu, kh, vh, attn_mask=bias))


def time_sdpa_backward_yardstick(q, k, v, p, u, vb, lens, dout, n_heads):
    """ms of the backward of one ``scaled_dot_product_attention`` call
    (gradients of its q, k and v for ``dout``) with the position scores
    given as its float attn_mask, as ``time_sdpa_yardstick``: a
    yardstick for the flash backward, not the same function."""
    import torch
    import torch.nn.functional as F

    from indic_cl_asr_torch.ops import flash_mhsa as fm

    B, T, E = q.shape
    H, D = n_heads, E // n_heads
    heads = lambda x: x.detach().reshape(B, T, H, D).transpose(1, 2).contiguous()
    with torch.no_grad():
        raw = torch.einsum("bthd,phd->bhtp", (q + vb.reshape(-1).to(q.dtype)).float()
                           .reshape(B, T, H, D), p.reshape(-1, H, D).float())
        t_idx = torch.arange(T, device=q.device)
        shift = (T - 1) + t_idx[None, :] - t_idx[:, None]
        bd = torch.gather(raw, 3, shift.expand(B, H, T, T)).to(q.dtype).float()
        mask = fm._mask(T, lens.to(torch.int64), -1, -1)
        bias = torch.where(mask, bd / math.sqrt(D), -1e30).to(q.dtype)
    leaves = [heads(x).requires_grad_(True)
              for x in (q + u.reshape(-1).to(q.dtype), k, v)]
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
        g = heads(dout.to(q.dtype))
        return cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))


def eval_flash_operands(dev, tasks, tok, spec):
    """Layer 0's attention operands in the CL evaluation's encoder batches,
    one batch of each (B, T): the first eval of phase 8's run_sequence
    (CL_LANGS[0]'s val_clean) through its Transcriber and a new flagship
    model of the same seed. Layer 0 is frozen, so its operands there are
    the run's; this runs outside the counted, timed runs."""
    import torch

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.train.eval import Transcriber

    model, _, _ = cl_setup(dev)
    tr = Transcriber(model=model, tokenizer=tok, languages=CL_LANGS, frontend=FrontendConfig(),
                     batch_size=16, bucket_spec=spec, greedy_impl="fused")
    seen = {}

    def hook(mod, args):
        x, pos_emb, lens = args[:3]
        seen.setdefault(tuple(x.shape[:2]), (
            mod.linear_q(x), mod.linear_k(x), mod.linear_v(x), mod.linear_pos(pos_emb),
            mod.pos_bias_u.to(x.dtype), mod.pos_bias_v.to(x.dtype), lens))

    handle = model.encoder.layers[0].self_attn.register_forward_pre_hook(hook)
    with torch.inference_mode():
        tr.transcribe(tasks[CL_LANGS[0]].val_clean, "ctc")
    handle.remove()
    return seen


def time_flash_eval_shapes(captured, rec):
    """The flash forward (CUDA events) and its plain version at the
    operands layer 0 gets in the CL evaluation's encoder batches
    (``eval_flash_operands``), with their bounds."""
    import torch

    from indic_cl_asr_torch.ops import flash_mhsa as fm

    out = {}
    with torch.inference_mode():
        for (B, T), args in sorted(captured.items()):
            q, lens = args[0], args[6]
            got = fm.flash_relpos_mhsa(*args, n_heads=8)
            ref = fm.flash_relpos_mhsa_reference(*args, n_heads=8).float()
            err = (got.float() - ref).abs().max().item()
            # the bf16 bar of phase 3 (inputs of unit scale) relative to
            # these outputs' scale, where one bf16 step is 2^-8 of a value
            tol = 2e-2 * max(1.0, ref.abs().max().item())
            times = flash_timings(args, n_heads=8)
            plain = cuda_ms(lambda: fm.flash_relpos_mhsa_reference(*args, n_heads=8), iters=5)
            nbytes, flops = fm.work(B, T, q.shape[2], lens.cpu(), itemsize=q.element_size())
            b_ms, b_by = bound_ms(nbytes, flops)
            out[f"B{B} T{T}"] = {**times, "plain_ms": plain, "bound_ms": b_ms,
                                 "bound_by": b_by, "max_abs_err": err, "lens": lens.tolist()}
            log(f"  flash forward at a CL eval batch B{B} T{T} {q.dtype}: "
                f"{times['ms']:.4f} ms (eager; graph {times['graph_ms']:.4f}, "
                f"device {times['device_ms']:.4f}), plain {plain:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}), err {err:.3e} (tol {tol:.3g}), lens "
                f"{lens.tolist()}")
            if not err <= tol:
                raise AssertionError(f"flash at eval batch B{B} T{T}: err {err} > {tol}")
    rec["flash_forward_eval_shapes"] = out


def flash_mma_shared_bytes(D):
    """Dynamic shared memory of a bf16 flash forward block at head dim D:
    ``MmaLayout<D>::BYTES`` of csrc/flash_mhsa.cu (rows of D + 8 halves;
    Qu and Qv's 2 x 64 rows, or the 4 warps' 16-row staging of 88 halves
    if larger; K, V and the 128-row window)."""
    ld = D + 8
    return (max(2 * 64 * ld, 4 * 16 * 88) + (2 * 64 + 128) * ld) * 2


def flash_bwd_mma_shared_bytes(D):
    """Dynamic shared memory of a bf16 flash backward block at head dim D:
    ``BwdLayout<D>::BYTES`` of csrc/flash_mhsa.cu (Qu, Qv, dO, K, V and
    the 128-row window in rows of D + 8 halves; each warp's dS and Pd rows
    of 72 halves; Z's 64 rows of 136 halves; 8 key tiles' keep masks of
    the 128 threads, 4 bytes each)."""
    return ((3 * 64 + 2 * 64 + 128) * (D + 8) + 4 * 2 * 16 * 72 + 64 * 136) * 2 + 8 * 128 * 4


def flash_bwd_atomics(T, lens, n_heads, D, left=-1, right=-1):
    """Atomic instructions one backward launch reaches (before the kernels
    skip adding zeros), from its grid: {"scalar": the design of the scalar
    kernel (flash_relpos_bwd_kernel, the f32 backward): one f32 atomicAdd
    an element, dk and dv per key row of every tile pair, dp per row of
    each tile pair's 127-row window; "mma": the bf16 kernel's, one 16-byte
    reduction per four elements, dk and dv per key row of every tile pair,
    dp per window row once a block (the window's lower 64 rows after each
    tile, all 128 after the last)}."""
    scalar = mma = 0
    for n in (max(0, min(int(x), T)) for x in lens):
        for t0 in range(0, n, 64):
            j_lo = max(0, t0 - left) if left >= 0 else 0
            j_hi = min(n, t0 + 64 + right) if right >= 0 else n
            tiles = list(range((j_lo // 64) * 64, j_hi, 64))
            for i, j0 in enumerate(tiles):
                g0 = (T - 1) + j0 - t0 - 63
                rows = min(64, n - j0)
                in_range = lambda a, b: sum(1 for g in range(g0 + a, g0 + b) if 0 <= g < 2 * T - 1)
                scalar += 2 * rows * D + in_range(0, 127) * D
                mma += 2 * rows * D // 4 + in_range(0, 128 if i == len(tiles) - 1 else 64) * D // 4
    return {"scalar": scalar * n_heads, "mma": mma * n_heads}


def ptxas_lines(source, kernel, by_dim=False):
    """ptxas's resource line (registers, spills, static shared memory) of
    each instantiation of ``kernel`` in the build log of ``source``, by
    compute type (and with ``by_dim`` by its int template argument, the
    head dim)."""
    from indic_cl_asr_torch.ops import _build

    out, func, spill = {}, "", ""
    for line in _build.BUILD_LOG.get(source, "").splitlines():
        if "Compiling entry function" in line:
            func, spill = line, ""
        elif "spill" in line:
            spill = "; " + line.strip()
        elif "registers" in line and kernel in func:
            key = "bf16" if "bfloat16" in func else "f32"
            dim = re.search(kernel + r"I\w*?Li(\d+)E", func) if by_dim else None
            key += f" D{dim.group(1)}" if dim else ""
            out[key] = line.split(":", 1)[-1].strip() + spill
    return out


def time_beam(model_inputs, launches, rec):
    """The fused beam at the long bucket's batch (B16 K4 P4,
    max_expansions 10, max_out 256, bf16): CUDA events over the kernel and
    its plain version, and its bound over the work its counters report."""
    import torch

    from indic_cl_asr_torch.ops import beam_fused as bfm

    f_proj, enc_lens = model_inputs["f_proj"], model_inputs["enc_lens"]
    args = (f_proj, enc_lens, model_inputs["lang"], model_inputs["model"])
    kw = dict(beam_size=4, max_expansions=10, max_out=256)
    with torch.inference_mode():
        ids, n, _ = bfm.rnnt_beam_search_fused(*args, **kw)
        ids_p, n_p, _ = bfm.rnnt_beam_search_fused_reference(*args, **kw)
        rows = int(((ids == ids_p).all(dim=1) & (n == n_p)).sum())
        bfm.reset_counts()
        ms = cuda_ms(lambda: bfm.rnnt_beam_search_fused(*args, **kw), iters=5, warmup=0)
        work_each = {k_: v_ // 5 for k_, v_ in bfm.work_counts().items()}
        # one call: the plain version's seconds are host-bound, and its
        # warm-up already ran above
        plain = cuda_ms(lambda: bfm.rnnt_beam_search_fused_reference(*args, **kw),
                        iters=1, warmup=0)
    B, T, Hj = f_proj.shape
    n_langs = int(model_inputs["lang"].unique().numel())
    nbytes, flops = bfm.work(B, T, Hj, 640, 257, work_each["joint_evals"],
                             work_each["lstm_steps"], n_langs=n_langs, itemsize=2)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  beam B{B} T{T} K4 bf16: {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {nbytes} B, {flops} flop), work {work_each}, tokens {n.tolist()}, "
        f"bf16 rows identical to plain {rows}/{B}")
    rec["beam_bf16_main_rows_identical"] = rows
    rec["beam_work_per_launch"] = work_each
    return {
        "name": "rnnt_beam_search_fused", "route": "cuda",
        "source": "indic_cl_asr_torch/csrc/beam_fused.cu",
        "replaces": "indic_cl_asr_tpu/ops/beam_fused_pallas.py:468",
        "launches": launches["rnnt_beam_search_fused"],
        # largest absolute score difference over the f32 rows of phase 3
        # whose ids equal the plain version's
        "max_abs_err": rec["beam_f32_max_abs_score_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }


def grad_err(got, want, dout):
    """Max abs error of a gradient over its scale: max|ref|, floored at
    1% of max|dout| for gradients that vanish in exact arithmetic (T=1:
    one key per row, so dS = 0 and only rounding residue remains)."""
    scale = max(want.float().abs().max().item(), 0.01 * dout.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


def check_flash_backward(dev, rec):
    import torch

    from indic_cl_asr_torch.ops.flash_mhsa import (
        dropout_bits,
        flash_dropout_bits_kernel,
        flash_relpos_mhsa,
        flash_relpos_mhsa_backward_reference,
        keep_threshold,
    )

    errs = {}
    for name, B, T, lens, (left, right), H, D in FLASH_CASES:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            for rate in (0.0, 0.1):
                args = flash_inputs(B, T, H, D, lens, dtype, dev, seed=T + B)
                kw = dict(n_heads=H, left=left, right=right, dropout_rate=rate, seed=T + 7)
                leaves = [a.detach().requires_grad_(True) for a in args[:6]]
                out = flash_relpos_mhsa(*leaves, args[6], **kw)
                g = torch.Generator().manual_seed(T)
                dout = torch.randn(out.shape, generator=g).to(dev, dtype)
                got = torch.autograd.grad(out, leaves, dout)
                want = flash_relpos_mhsa_backward_reference(*args, dout, **kw)
                torch.cuda.synchronize()
                worst = max(grad_err(a, b, dout) for a, b in zip(got, want))
                tag = f"{name} {str(dtype).split('.')[-1]} drop {rate}"
                errs[tag] = worst
                log(f"  flash backward {tag}: max err / max|ref| {worst:.3e} (tol {tol:g})")
                if not (worst <= tol):
                    raise AssertionError(f"flash backward {tag}: {worst} > {tol}")
    rec["flash_backward_rel_errors"] = errs
    # a (0, 0) band: each row sees its own key alone, so the forward's lse
    # is that key's score; the bf16 backward rebuilds the forward's scores
    # bit for bit, so P = exp(s - lse) = 1, dS = 0, and the gradients of
    # q, k, p and the biases are exactly zero (dv is P·dO)
    for rate in (0.0, 0.1):
        args = flash_inputs(4, 204, 8, 64, [204, 150, 1, 0], torch.bfloat16, dev, seed=31)
        kw = dict(n_heads=8, left=0, right=0, dropout_rate=rate, seed=17)
        leaves = [a.detach().requires_grad_(True) for a in args[:6]]
        out = flash_relpos_mhsa(*leaves, args[6], **kw)
        dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)).to(dev, torch.bfloat16)
        got = torch.autograd.grad(out, leaves, dout)
        want = flash_relpos_mhsa_backward_reference(*args, dout, **kw)
        torch.cuda.synchronize()
        nonzero = {name: int(torch.count_nonzero(g)) for name, g in
                   zip(("q", "k", "v", "p", "bias_u", "bias_v"), got) if name != "v"}
        dv_err = grad_err(got[2], want[2], dout)
        log(f"  flash backward band(0,0) bf16 drop {rate}: nonzero entries {nonzero} "
            f"(all must be 0), dv err / max|ref| {dv_err:.3e}")
        if any(nonzero.values()) or not dv_err <= 2e-2:
            raise AssertionError(f"flash backward band(0,0) drop {rate}: {nonzero}, dv {dv_err}")
        rec[f"flash_backward_band00_drop{rate}"] = {"nonzero": nonzero, "dv_rel_err": dv_err}
    bits = flash_dropout_bits_kernel(987654321, 16, 8, 204, dev)
    want = dropout_bits(987654321, 16, 8, 204, dev)
    keep = (bits <= keep_threshold(0.1)).double().mean().item()
    log(f"  dropout bits B16 H8 T204: equal {torch.equal(bits, want)}, keep rate "
        f"{keep:.5f} at rate 0.1")
    if not torch.equal(bits, want) or abs(keep - 0.9) >= 5e-3:
        raise AssertionError("flash dropout bits differ from the plain version's")
    rec["dropout_bits"] = {"equal": True, "keep_rate": keep}


def lattice_inputs(dev, B=16, T=204, U1=129, seed=0, t_lens=None, u_lens=None):
    """Seeded slabs [B, T, U1] and lengths; by default the flagship
    training batch's shape with rows of u_len 0, t_len 1 and t_len < T."""
    import torch

    g = torch.Generator().manual_seed(seed)
    lb = -torch.rand((B, T, U1), generator=g) * 3
    ll = -torch.rand((B, T, U1), generator=g) * 3
    t_lens = torch.tensor(t_lens or [T] * 12 + [1, 150, 100, T], dtype=torch.int32)
    u_lens = torch.tensor(u_lens or [U1 - 1, 0, 64, 1] * 4, dtype=torch.int32)
    return lb.to(dev), ll.to(dev), t_lens.to(dev), u_lens.to(dev)


# a lattice above the warp kernels' U+1 (ops/rnnt_loss.py:WARP_MAX_U1),
# which the block kernels carry
LATTICE_ABOVE = dict(B=4, T=64, U1=600, t_lens=[64, 1, 40, 64], u_lens=[599, 0, 300, 17])


def check_lattice(dev, rec):
    import torch

    from indic_cl_asr_torch.ops import _build
    from indic_cl_asr_torch.ops import rnnt_loss as R

    if _build.load("rnnt_lattice").rnnt_lattice_warp_max_u1() != R.WARP_MAX_U1:
        raise AssertionError("rnnt_lattice.cu's warp threshold differs from WARP_MAX_U1")
    bad = R.lae_mismatches(dev)
    rec["lattice_lae_mismatches"] = bad
    log(f"  the lattice kernels' exp and log1p against expf over every float of [-inf, -0] "
        f"and log1pf over every float of [0, 1]: {bad} differ (must be 0)")
    if bad:
        raise AssertionError(f"the lattice's exp or log1p differs from the library's at {bad}")
    rec["lattice_errors"] = {}
    for case in (dict(), LATTICE_ABOVE):
        lb, ll, tl, ul = lattice_inputs(dev, **case)
        B, T, U1 = lb.shape
        name_case = f"B{B} T{T} U+1 {U1}"
        lpb, lpl, _, _ = R._prepare(lb, ll, tl, ul)
        out = {"kernel": R.lattice_kernel(U1)}
        for name, got, want in (("alpha", R.rnnt_alpha(lpb, lpl), R._alpha_scan(lpb, lpl)),
                                ("beta", R.rnnt_beta(lpb, lpl, ul), R._beta_scan(lpb, lpl, ul))):
            fin = want > R.NEG_INF / 2
            if not torch.equal(fin, got > R.NEG_INF / 2):
                raise AssertionError(f"{name} {name_case}: finite entries differ")
            err = (got[fin] - want[fin]).abs().max().item()
            out[name] = err
            log(f"  {name} {name_case} ({out['kernel']} kernel): max abs err {err:.3e} on "
                f"finite entries (tol 1e-4)")
            if not (err <= 1e-4):
                raise AssertionError(f"{name} {name_case}: {err} > 1e-4")
        x, y = lb.clone().requires_grad_(True), ll.clone().requires_grad_(True)
        nll = R.rnnt_nll_from_logprobs(x, y, tl, ul)
        gx, gy = torch.autograd.grad(nll.sum(), (x, y))
        xp, yp = lb.clone().requires_grad_(True), ll.clone().requires_grad_(True)
        nll_p = R.rnnt_nll_from_logprobs_reference(xp, yp, tl, ul)
        gxp, gyp = torch.autograd.grad(nll_p.sum(), (xp, yp))
        out["nll_rel"] = ((nll - nll_p).abs() / nll_p.abs()).max().item()
        out["grad_rel"] = max((a - b).abs().max().item() / b.abs().max().item()
                              for a, b in ((gx, gxp), (gy, gyp)))
        log(f"  rnnt nll {name_case} rel err {out['nll_rel']:.3e}, slab grads rel err "
            f"{out['grad_rel']:.3e} (tol 1e-5)")
        if not (out["nll_rel"] <= 1e-5 and out["grad_rel"] <= 1e-5):
            raise AssertionError(f"rnnt loss {name_case} through the lattice kernels: {out}")
        rec["lattice_errors"][name_case] = out


def check_head_dim_route(dev, rec):
    """A flash config at head dim 256 (d_model 512 in 2 heads, 2 layers):
    the eager route chosen at construction, no flash launch, and the card's
    encoder output against the CPU's (f32, atol 1e-4)."""
    import dataclasses

    import torch

    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, init_weights_, tiny_config
    from indic_cl_asr_torch.ops.flash_mhsa import flash_relpos_mhsa

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, d_model=512, n_heads=2, attn_impl="flash"))
    g = torch.Generator().manual_seed(7)
    feats = torch.randn((3, 32, 96), generator=g)
    lens = torch.tensor([96, 61, 9], dtype=torch.int32)
    outs = {}
    n0 = flash_relpos_mhsa.launches
    for d in ("cpu", dev):
        m = init_weights_(HybridRNNTCTC(cfg, device=d), torch.Generator().manual_seed(5))
        with torch.no_grad():
            outs[str(d)] = m.encode(feats.to(d), lens.to(d))[0].cpu()
    route = m.encoder.attention_route
    err = (outs[str(dev)] - outs["cpu"]).abs().max().item()
    launches = flash_relpos_mhsa.launches - n0
    rec["head_dim_256"] = {"route": route, "max_abs_err": err, "flash_launches": launches}
    log(f"  flash config at head dim 256: attention route {route!r}, flash launches "
        f"{launches}, card vs CPU encoder max abs err {err:.3e} (tol 1e-4)")
    if route != "xla" or launches or not (err <= 1e-4):
        raise AssertionError(f"head dim 256 encoder: {rec['head_dim_256']}")


def joint_inputs(dev, dtype, B=16, T=204, U1=129, H=640, V1=257, seed=0):
    """The fused joint's operands at the flagship's shapes: f, g in
    ``dtype``, the f32 heads of two languages gathered per row, labels
    with the pad column 0 and one label outside the head, and slab
    cotangents that are 0 past a quarter of the frames from the end (the
    frames past a row's length)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    f = 0.5 * torch.randn((B, T, H), generator=gen)
    g = 0.5 * torch.randn((B, U1, H), generator=gen)
    heads = torch.randn((2, H, V1), generator=gen) * H ** -0.5 * 4
    hb = 0.1 * torch.randn((2, V1), generator=gen)
    lang = torch.arange(B) % 2
    labels = torch.randint(0, V1 - 1, (B, U1), generator=gen, dtype=torch.int32)
    labels[:, -1] = 0
    labels[0, 0] = V1 + 5
    cots = [torch.randn((B, T, U1), generator=gen) for _ in range(2)]
    for c in cots:
        c[:, T - T // 4:] = 0.0
    args = [f.to(dev, dtype), g.to(dev, dtype), heads[lang].to(dev), hb[lang].to(dev),
            labels.to(dev)]
    return args, [c.to(dev) for c in cots]


def check_joint(dev, rec):
    import torch

    from indic_cl_asr_torch.ops import joint_fused as J
    from indic_cl_asr_torch.ops.flash_mhsa import keep_threshold

    errs = {}
    for dtype, grad_tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for rate in (0.0, 0.2):
            args, (dlpb, dlpl) = joint_inputs(dev, dtype)
            V1 = args[2].shape[2]
            kw = dict(blank=V1 - 1, dropout_rate=rate)
            out = {}
            for name, fn in (("kernel", J.joint_slabs), ("plain", J.joint_slabs_reference)):
                leaves = [a.clone().requires_grad_(True) for a in args[:4]]
                lpb, lpl = fn(*leaves, args[4], 1234, **kw)
                grads = torch.autograd.grad((lpb * dlpb + lpl * dlpl).sum(), leaves)
                out[name] = (lpb, lpl, grads)
            with torch.no_grad():  # the forward evaluated exactly: f64 head and sums
                xb, xl = J._forward_reference(*args[:2], args[2].double(), args[3].double(),
                                              args[4], 1234, V1 - 1, rate)
            torch.cuda.synchronize()
            (kb, kl, kg), (pb, pl, pg) = out["kernel"], out["plain"]
            slab = max((kb - xb).abs().max().item(), (kl - xl).abs().max().item())
            slab_plain = max((kb - pb).abs().max().item(), (kl - pl).abs().max().item())
            plain_exact = max((pb - xb).abs().max().item(), (pl - xl).abs().max().item())
            grad = {n: (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                    for n, a, b in zip(("df", "dg", "dW", "db"), kg, pg)}
            tag = f"B16 T204 U+1 129 {str(dtype).split('.')[-1]} drop {rate}"
            errs[tag] = {"slabs_abs": slab, "slabs_abs_vs_f32_plain": slab_plain,
                         "f32_plain_slabs_abs": plain_exact, **grad}
            log(f"  joint {tag}: slabs max abs err {slab:.3e} (tol 1e-5; against the f32 plain "
                f"version {slab_plain:.3e}, which is {plain_exact:.3e} off); grads err / "
                f"max|ref| " + ", ".join(f"{n} {e:.3e}" for n, e in grad.items())
                + f" (tol df, dg {grad_tol:g}; dW, db 1e-5)")
            dtypes_ok = all(a.dtype == b.dtype for a, b in zip(kg, pg))
            if not (slab <= 1e-5 and grad["df"] <= grad_tol and grad["dg"] <= grad_tol
                    and grad["dW"] <= 1e-5 and grad["db"] <= 1e-5 and dtypes_ok):
                raise AssertionError(f"joint {tag}: {errs[tag]}")
    rec["joint_errors"] = errs
    bits = J.joint_dropout_bits_kernel(987654321, 4, 41, 129, 640, dev)
    want = J.dropout_bits(987654321, 4, 129, 640, 0, 41, dev)
    keep = (bits <= keep_threshold(0.2)).double().mean().item()
    log(f"  joint dropout bits B4 T41 U+1 129 H640: equal {torch.equal(bits, want)}, "
        f"keep rate {keep:.5f} at rate 0.2")
    if not torch.equal(bits, want) or abs(keep - 0.8) >= 2e-3:
        raise AssertionError("joint dropout bits differ from the plain version's")
    rec["joint_dropout_bits"] = {"equal": True, "keep_rate": keep}


def training_batches(entries, tok, langs, n, seed=0):
    """``n`` BatchPipeline batches of 16 from the 4-8 s bucket (a new
    shuffle every epoch of its 16 entries)."""
    from indic_cl_asr_torch.data.pipeline import BatchPipeline, BucketSpec

    spec = BucketSpec(boundaries_sec=(4.0, 8.0), max_tokens=(64, 128))
    long = [e for e in entries if spec.bucket_of(e.duration) == 1]
    pipe = BatchPipeline(long, tok, langs, batch_size=16, spec=spec, shuffle=True,
                         seed=seed, num_io_threads=4)
    out = []
    while len(out) < n:
        out.extend(pipe)
    return out[:n]


def counted_wrappers():
    """{kernel name: the wrapper that counts its launches}."""
    from indic_cl_asr_torch.ops import decode_fused as dfm
    from indic_cl_asr_torch.ops import flash_mhsa as fm
    from indic_cl_asr_torch.ops import joint_fused as J
    from indic_cl_asr_torch.ops import rnnt_loss as R

    return {"flash_relpos_mhsa": fm.flash_relpos_mhsa,
            "flash_relpos_mhsa_backward": fm.flash_relpos_mhsa_backward,
            "rnnt_alpha": R.rnnt_alpha, "rnnt_beta": R.rnnt_beta,
            "joint_fused_forward": J.joint_fused_forward,
            "joint_fused_backward": J.joint_fused_backward,
            "rnnt_greedy_decode_fused": dfm.rnnt_greedy_decode_fused}


def training_counts():
    return {k: w.launches for k, w in counted_wrappers().items()
            if k != "rnnt_greedy_decode_fused"}


def reset_training_counts():
    for w in counted_wrappers().values():
        w.launches = 0


def capture_training_inputs(step, batch):
    """Run one step with the training kernels' wrappers recording their
    arguments (outside any counted run): the first flash backward's
    operands and the lattice slabs, at the shapes the step gives them."""
    import torch

    from indic_cl_asr_torch.ops import flash_mhsa as fm
    from indic_cl_asr_torch.ops import rnnt_loss as R

    seen = {}
    originals = (fm.flash_relpos_mhsa_backward, R.rnnt_alpha, R.rnnt_beta)

    def bwd(*a, **kw):
        seen.setdefault("flash_bwd", (a, kw))
        return originals[0](*a, **kw)

    def alpha(*a):
        seen.setdefault("alpha", a)
        return originals[1](*a)

    def beta(*a):
        seen.setdefault("beta", a)
        return originals[2](*a)

    # the wrapped functions count their launches on the module's name
    bwd.launches = alpha.launches = beta.launches = 0
    fm.flash_relpos_mhsa_backward, R.rnnt_alpha, R.rnnt_beta = bwd, alpha, beta
    try:
        step(batch, torch.Generator().manual_seed(999))
    finally:
        fm.flash_relpos_mhsa_backward, R.rnnt_alpha, R.rnnt_beta = originals
    torch.cuda.synchronize()
    return seen


def profile_step(step, batch, wall_ms, top=14):
    """torch.profiler over one training step: device-busy ms against
    ``wall_ms`` (an unprofiled step), and the kernels that take most."""
    import torch

    from indic_cl_asr_torch.utils.profiling import device_profile

    prof = device_profile(lambda: step(batch, torch.Generator().manual_seed(5)), top)
    busy_ms = prof["device_busy_ms"]
    rows = [dict(r, name=r["name"][:90]) for r in prof["top"]]
    log(f"  profile (one training step): device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall unprofiled (idle share {1 - busy_ms / wall_ms:.3f}); "
        f"{prof['device_ops']} device kernels and copies")
    for r in rows:
        log(f"    {r['device_ms']:9.3f} ms  {r['calls']:6d}x  {r['name']}")
    host_rows = [dict(r, name=r["name"][:60]) for r in prof["top_host"]]
    log("  host ops by self time (profiled, so inflated):")
    for r in host_rows:
        log(f"    {r['host_ms']:9.3f} ms  {r['calls']:6d}x  {r['name']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "device_ops": prof["device_ops"], "top": rows,
            "top_host": host_rows}


def time_lstm(model, B, U1):
    """Forward + backward of the prediction net's LSTM over a training
    step's U+1 label positions: one torch.lstm call (the training path)
    against the Python step loop (the decode path's arithmetic)."""
    import torch

    lstm = model.prediction.lstm[0]
    g = torch.Generator().manual_seed(3)
    x = torch.randn((B, U1, lstm.hidden), generator=g).to(model.device, lstm.dtype)
    x.requires_grad_(True)
    leaves = [x, lstm.w_ih, lstm.w_hh, lstm.bias]

    def fwd_bwd(fn):
        out = fn(x)[0]
        torch.autograd.grad(out.float().square().sum(), leaves)

    res = {"sequence_op": cuda_ms(lambda: fwd_bwd(lstm.sequence), iters=5),
           "python_steps": cuda_ms(lambda: fwd_bwd(lstm.steps), iters=3, warmup=1)}
    log(f"  prediction LSTM B{B} U+1 {U1} fwd+bwd: torch.lstm {res['sequence_op']:.3f} ms, "
        f"Python step loop {res['python_steps']:.3f} ms")
    return res


def run_training(dev, rec, entries, tok, langs, timed_steps=5, overfit_steps=30):
    import torch

    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, flagship_config, init_weights_
    from indic_cl_asr_torch.train.state import make_optimizer
    from indic_cl_asr_torch.train.step import StepConfig, batch_to_device_dict, make_train_step

    model = HybridRNNTCTC(flagship_config(torch.bfloat16, attn_impl="flash", frozen_till=12),
                          device=dev)
    init_weights_(model, torch.Generator().manual_seed(0))
    opt = make_optimizer(model, lr=1e-4, weight_decay=0.01, freeze_encoder_till=12,
                         device=dev)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n not in set(opt.names)}
    # scripts/config.yaml: chunk 64, rnnt_remat none, uniform_lang_head, ctc weight 0.5
    step_cfg = StepConfig(rnnt_chunk_size=64, rnnt_remat="none", uniform_lang_head=True,
                          ctc_loss_weight=0.5)
    step = make_train_step(model, step_cfg, opt, device=dev)
    batches = training_batches(entries, tok, langs, 2 + timed_steps)
    B, S = batches[0].audio.shape
    U = batches[0].tokens.shape[1]
    gen = torch.Generator().manual_seed(0)
    for b in batches[:2]:  # warm-up: cuBLAS handles, kernel loads, allocator
        step(batch_to_device_dict(b, dev), gen)
    torch.cuda.synchronize()

    # --- the main path: counts reset just before, read just after ---
    torch.cuda.reset_peak_memory_stats()
    reset_training_counts()
    t0 = time.perf_counter()
    auxes = [step(batch_to_device_dict(b, dev), gen) for b in batches[2:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = training_counts()
    peak = torch.cuda.max_memory_allocated()
    n = timed_steps
    log(f"  launches over {n} steps: {launches}")
    want = {"flash_relpos_mhsa": 17 * n, "flash_relpos_mhsa_backward": 5 * n,
            "rnnt_alpha": n, "rnnt_beta": n, "joint_fused_forward": 0,
            "joint_fused_backward": 0}
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    losses = [{k: float(v) for k, v in a.items()} for a in auxes]
    if not all(math.isfinite(v) for a in losses for v in a.values()):
        raise AssertionError(f"non-finite training loss: {losses}")
    ms = wall * 1e3 / n
    log(f"  B{B} S{S} U{U} bf16: {ms:.2f} ms/step, {B * n / wall:.2f} utts/s, peak "
        f"{peak / 2**30:.2f} GiB; losses {[round(a['train_loss'], 4) for a in losses]}")
    rec["training"] = {"batch": B, "samples": S, "tokens": U, "steps": n,
                       "ms_per_step": ms, "utts_per_s": B * n / wall,
                       "peak_memory_bytes": peak, "launches": launches, "losses": losses}
    fixed = batch_to_device_dict(batches[-1], dev)
    rec["training"]["profile"] = profile_step(step, fixed, ms)
    rec["training"]["lstm_ms"] = time_lstm(model, B, U + 1)
    captured = capture_training_inputs(step, fixed)

    # --- overfit one fixed batch ---
    over = [float(step(fixed, gen)["train_loss"]) for _ in range(overfit_steps)]
    first, last = sum(over[:5]) / 5, sum(over[-5:]) / 5
    log(f"  overfit one batch, {overfit_steps} steps: mean of the first 5 losses "
        f"{first:.4f}, of the last 5 {last:.4f}")
    if not (all(math.isfinite(v) for v in over) and last < first):
        raise AssertionError(f"the loss does not fall on a fixed batch: {over}")
    rec["training"]["overfit_losses"] = over
    for name, p in model.named_parameters():
        if name in frozen and not torch.equal(p, frozen[name]):
            raise AssertionError(f"frozen parameter {name} changed")
    log(f"  {len(frozen)} frozen parameters bit-unchanged after "
        f"{2 + n + 2 + overfit_steps} steps")
    del model, opt, step, frozen
    torch.cuda.empty_cache()
    return launches, captured, batches[-1]


# parameters whose gradient is zero in exact arithmetic, and the parameter
# whose gradient scale their rounding residue is held to: the key bias
# shifts every score of a query row alike (the softmax ignores it), and the
# depthwise conv bias is removed again by train-mode BatchNorm's mean
ZERO_GRADIENT = {"linear_k.bias": "linear_k.weight",
                 "depthwise_conv.bias": "depthwise_conv.weight"}


def gradient_owner(name):
    """``name``, or its weight's where its own gradient is only rounding
    residue (ZERO_GRADIENT)."""
    for bias, weight in ZERO_GRADIENT.items():
        if name.endswith(bias):
            return name[: -len(bias)] + weight
    return name


def grad_scale(name, grads):
    """max|grad| of parameter ``name``'s gradient owner."""
    return max(grads[gradient_owner(name)].abs().max().item(), 1e-30)


def check_step_f32(dev, rec, host_batch, rnnt_impl="xla", lr=1e-4):
    """One f32 step at flagship width, 4 layers (2 frozen), B4, on the card
    through the kernels and on the CPU through the plain versions, with
    the RNNT joint of ``rnnt_impl``."""
    import dataclasses

    import numpy as np
    import torch

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, flagship_config, init_weights_
    from indic_cl_asr_torch.train.state import make_optimizer
    from indic_cl_asr_torch.train.step import StepConfig, make_train_step

    cfg = flagship_config(torch.float32, n_layers=4, attn_impl="flash", frozen_till=2)
    cfg = dataclasses.replace(
        cfg, pred_dropout=0.0, joint_dropout=0.0,
        encoder=dataclasses.replace(cfg.encoder, dropout=0.0, dropout_pre_encoder=0.0,
                                    dropout_att=0.1))
    step_cfg = StepConfig(frontend=FrontendConfig(dither=0.0), rnnt_chunk_size=64,
                          rnnt_remat="none", uniform_lang_head=True, rnnt_impl=rnnt_impl)
    np_batch = {"audio": host_batch.audio[:4], "audio_len": host_batch.audio_len[:4],
                "tokens": host_batch.tokens[:4], "token_len": host_batch.token_len[:4],
                "lang_ids": host_batch.lang_ids[:4]}
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = HybridRNNTCTC(cfg, device=device)
        init_weights_(model, torch.Generator().manual_seed(7))
        opt = make_optimizer(model, lr=lr, freeze_encoder_till=2, device=device)
        grads = {}
        apply = opt.step

        def record(gs, opt=opt, grads=grads, apply=apply):
            grads.update(zip(opt.names, (g.detach().cpu() for g in gs)))
            apply(gs)

        opt.step = record
        step = make_train_step(model, step_cfg, opt, device=device)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in np_batch.items()}
        batch["n_valid"] = 4
        before = training_counts()
        t0 = time.perf_counter()
        aux = step(batch, torch.Generator().manual_seed(123))
        aux = {k: float(v) for k, v in aux.items()}
        secs = time.perf_counter() - t0
        counted = {k: v - before[k] for k, v in training_counts().items()}
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        out[name] = (aux, grads, state, counted, secs)
        del model, opt, step
    (aux_c, g_c, s_c, n_c, t_c), (aux_p, g_p, s_p, n_p, t_p) = out["card"], out["cpu"]
    joint = int(rnnt_impl == "pallas")
    want = {"flash_relpos_mhsa": 4, "flash_relpos_mhsa_backward": 2, "rnnt_alpha": 1,
            "rnnt_beta": 1, "joint_fused_forward": joint, "joint_fused_backward": joint}
    if n_c != want or any(n_p.values()):
        raise AssertionError(f"f32 step launches: card {n_c}, cpu {n_p}")
    loss_rel = max(abs(aux_c[k] - aux_p[k]) / abs(aux_p[k]) for k in aux_p)
    grad_rel = max((g_c[k] - g).abs().max().item() / grad_scale(k, g_p)
                   for k, g in g_p.items())
    stats = [k for k in s_p if k.endswith(("running_mean", "running_var"))]
    bn_err = max((s_c[k] - s_p[k]).abs().max().item() for k in stats)
    par_err = max((s_c[k] - s_p[k]).abs().max().item() for k in s_p if k not in stats)
    res = {"losses_card": aux_c, "losses_cpu": aux_p, "loss_rel_err": loss_rel,
           "grad_err_over_max": grad_rel, "bn_stats_abs_err": bn_err,
           "param_abs_err": par_err, "card_s": t_c, "cpu_s": t_p}
    log(f"  f32 step ({rnnt_impl}), card vs CPU: loss rel err {loss_rel:.3e} (tol 1e-4), grad err / "
        f"max|grad| {grad_rel:.3e} (1e-3), BatchNorm stats {bn_err:.3e} (1e-5), params "
        f"{par_err:.3e} ({2 * lr + 1e-6:g}); card {t_c:.2f} s, CPU {t_p:.2f} s")
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3 and bn_err <= 1e-5
            and par_err <= 2 * lr + 1e-6):
        raise AssertionError(f"f32 step ({rnnt_impl}) card vs CPU: {res}")
    rec[f"step_f32_card_vs_cpu_{rnnt_impl}"] = res


def time_training_kernels(captured, launches, rec):
    import torch

    from indic_cl_asr_torch.ops import flash_mhsa as fm
    from indic_cl_asr_torch.ops import rnnt_loss as R

    lines = []
    args, kw = captured["flash_bwd"]
    q, k, v, p, u, vb, lens, lse, dout = args
    B, T, E = q.shape
    got = fm.flash_relpos_mhsa_backward(*args, **kw)
    want = fm.flash_relpos_mhsa_backward_reference(q, k, v, p, u, vb, lens, dout, **kw)
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    times = flash_bwd_timings(args, **kw)
    ms = times["ms"]
    plain = cuda_ms(lambda: fm.flash_relpos_mhsa_backward_reference(
        q, k, v, p, u, vb, lens, dout, **kw), iters=5)
    nbytes, flops = fm.work_backward(B, T, E, lens.cpu(), kw["n_heads"],
                                     itemsize=q.element_size())
    b_ms, b_by = bound_ms(nbytes, flops)
    sdpa_ms = time_sdpa_backward_yardstick(q, k, v, p, u, vb, lens, dout, kw["n_heads"])
    atomics = flash_bwd_atomics(T, lens.tolist(), kw["n_heads"], E // kw["n_heads"])
    rec["flash_backward_training_shapes"] = {
        **times, "sdpa_backward_ms": sdpa_ms, "atomics": atomics,
        "dropout_rate": kw["dropout_rate"],
        "sdpa_is": ("scaled_dot_product_attention's backward, position scores given as its "
                    "float attn_mask (not the same function)")}
    lines.append({
        "name": "flash_relpos_mhsa_backward", "route": "cuda",
        "source": "indic_cl_asr_torch/csrc/flash_mhsa.cu",
        "replaces": "indic_cl_asr_tpu/ops/flash_mhsa.py:416",
        "launches": launches["flash_relpos_mhsa_backward"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "graph_ms": times["graph_ms"], "device_ms": times["device_ms"],
    })
    log(f"  flash backward B{B} T{T} E{E} bf16 (dropout {kw['dropout_rate']}): {ms:.4f} ms "
        f"(CUDA events over eager calls; on operands cast first {times['ms_cast']:.4f}, "
        f"over a graph of calls {times['graph_ms']:.4f}, "
        f"profiled device time {times['device_ms']:.4f}), plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {nbytes} B, {flops} flop), err {err:.3e}; SDPA's "
        f"backward with the position scores given {sdpa_ms:.4f} ms; atomics a launch "
        f"{atomics}")
    # the forward at the same operands with the step's dropout, for PERF's row 1
    with torch.no_grad():
        drop = flash_timings((q, k, v, p, u, vb, lens), **kw)
        no_drop = flash_timings((q, k, v, p, u, vb, lens), **dict(kw, dropout_rate=0.0))
    rec["flash_forward_training_shapes"] = {"dropout": drop, "no_dropout": no_drop,
                                            "dropout_rate": kw["dropout_rate"]}
    log(f"  flash forward at the same operands: {drop['ms']:.4f} ms with dropout "
        f"{kw['dropout_rate']} (graph {drop['graph_ms']:.4f}, device {drop['device_ms']:.4f}), "
        f"{no_drop['ms']:.4f} ms without (graph {no_drop['graph_ms']:.4f}, "
        f"device {no_drop['device_ms']:.4f})")

    lpb, lpl = captured["alpha"]
    B, T, U1 = lpb.shape
    ul = captured["beta"][2]
    for name, fn, plain_fn, beta in (
        ("rnnt_alpha", lambda: R.rnnt_alpha(lpb, lpl), lambda: R._alpha_scan(lpb, lpl), False),
        ("rnnt_beta", lambda: R.rnnt_beta(lpb, lpl, ul), lambda: R._beta_scan(lpb, lpl, ul), True),
    ):
        got, want = fn(), plain_fn()
        fin = want > R.NEG_INF / 2
        err = (got[fin] - want[fin]).abs().max().item()
        ms = cuda_ms(fn)
        graph = cuda_graph_ms(fn)
        dev_ms = device_ms(fn, "beta" if beta else "alpha")
        plain = cuda_ms(plain_fn, iters=3, warmup=1)
        nbytes, flops = R.work(B, T, U1, beta=beta)
        b_ms, b_by = bound_ms(nbytes, flops)
        lines.append({
            "name": name, "route": "cuda",
            "source": "indic_cl_asr_torch/csrc/rnnt_lattice.cu",
            "replaces": ("indic_cl_asr_tpu/ops/rnnt_loss_pallas.py:112" if beta
                         else "indic_cl_asr_tpu/ops/rnnt_loss_pallas.py:94"),
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "kernel": R.lattice_kernel(U1), "graph_ms": graph,
            "device_ms": dev_ms,
        })
        log(f"  {name} B{B} T{T} U+1 {U1} ({R.lattice_kernel(U1)} kernel): {ms:.4f} ms "
            f"(over a graph of calls {graph:.4f}, profiled device time {dev_ms:.4f}), plain "
            f"{plain:.4f} ms, bound {b_ms:.5f} ms ({b_by}; {nbytes} B, {flops} flop), "
            f"err {err:.3e}")
    return lines


CL_LANGS = ["hindi", "bengali"]
CL_METHODS = ("naive", "ewc", "mas", "lwf")
CL_SETS = ("val_clean", "val_noisy", "test_clean", "test_noisy")


def make_cl_data(root):
    """Per language: 32 training WAVs of 4.5-8 s (two batches of 16 in the
    4-8 s bucket) and 8 WAVs each of val and test, clean (noise std 0.05)
    and noisy (0.3), of 2.5-8 s. Returns the TaskData by language and the
    tokenizer, a char tokenizer per language trained on its words."""
    from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer
    from indic_cl_asr_torch.train.driver import TaskData

    tasks, toks = {}, {}
    for k, lang in enumerate(CL_LANGS):
        train, words = make_data(root, 32, seed=10 + k, lang=lang, durations=((4.5, 8.0),),
                                 prefix=f"{lang}_train")
        sets = [make_data(root, 8, seed=20 + 4 * k + j, lang=lang,
                          noise=0.3 if name.endswith("noisy") else 0.05,
                          prefix=f"{lang}_{name}")[0]
                for j, name in enumerate(CL_SETS)]
        tasks[lang] = TaskData(train, *sets)
        toks[lang] = CharTokenizer.train([" ".join(words)] * 4)
    return tasks, MultilingualTokenizer(toks)


def cl_setup(dev, rnnt_impl="pallas"):
    """The flagship model (bf16, flash attention, layers 0-11 frozen) with
    seeded random weights, its AdamW (lr 1e-4, wd 0.01) and the step
    config of scripts/config.yaml with the given joint."""
    import torch

    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, flagship_config, init_weights_
    from indic_cl_asr_torch.train.state import make_optimizer
    from indic_cl_asr_torch.train.step import StepConfig

    model = HybridRNNTCTC(flagship_config(torch.bfloat16, attn_impl="flash", frozen_till=12),
                          device=dev)
    init_weights_(model, torch.Generator().manual_seed(0))
    opt = make_optimizer(model, lr=1e-4, weight_decay=0.01, freeze_encoder_till=12,
                         device=dev)
    step_cfg = StepConfig(rnnt_chunk_size=64, rnnt_remat="none", uniform_lang_head=True,
                          ctc_loss_weight=0.5, rnnt_impl=rnnt_impl)
    return model, opt, step_cfg


def cl_method(name, model, step_cfg, opt):
    """The CL method with the hyper-parameters of scripts/config.yaml."""
    from indic_cl_asr_torch.cl import ewc as E
    from indic_cl_asr_torch.cl import lwf as L
    from indic_cl_asr_torch.cl import mas as M
    from indic_cl_asr_torch.cl import methods as CM

    if name == "naive":
        return CM.NaiveMethod()
    if name == "ewc":
        return CM.EWCMethod(E.EWCConfig(e_lambda=10.0), model, step_cfg, opt)
    if name == "mas":
        return CM.MASMethod(M.MASConfig(mas_lambda=1.0, mas_ctx=0.3), model, step_cfg, opt)
    return CM.LwFMethod(L.LwFConfig(knowledge_distillation=0.1, knowledge_distillation_ctx=1.0),
                        model, step_cfg, opt)


def bn_stats(model):
    return {n: b.clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def same_tensors(a, b):
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


def watch_method(method, model, seen):
    """Wrap the method's hooks: every importance batch must leave the
    model's BatchNorm statistics bit-unchanged, and an LwF teacher's
    statistics must be those it was made with when the next task
    replaces it. Counts importance batches and checked teachers."""
    importance = method.importance_batch

    def importance_batch(acc, batch, generator):
        before = bn_stats(model)
        acc = importance(acc, batch, generator)
        if not same_tensors(before, bn_stats(model)):
            raise AssertionError(f"{method.name}: an importance batch changed the "
                                 "BatchNorm statistics")
        seen["importance_batches"] += 1
        return acc

    method.importance_batch = importance_batch
    if method.name != "lwf":
        return
    end = method.end_task

    def end_task(*args):
        if method.teacher is not None:
            if not same_tensors(seen["teacher_stats"], bn_stats(method.teacher)):
                raise AssertionError("lwf: the teacher's forwards changed its BatchNorm "
                                     "statistics")
            seen["teachers_checked"] += 1
        end(*args)
        seen["teacher_stats"] = bn_stats(method.teacher)

    method.end_task = end_task


def step_records(path):
    """The per-step train records of a run's metrics.jsonl."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if any(k.startswith("train/train_loss_") for k in r)]


def run_cl_method(dev, name, tasks, tok, spec, root):
    """One run_sequence over CL_LANGS with CL method ``name`` and every
    check of phase 8; returns its record and its launch counts."""
    import collections

    import numpy as np
    import torch

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.train.driver import DriverConfig, run_sequence
    from indic_cl_asr_torch.train.eval import Transcriber
    from indic_cl_asr_torch.train.logger import Logger
    from indic_cl_asr_torch.train.metrics import compute_perf_matrix

    model, opt, step_cfg = cl_setup(dev)
    trainable = set(opt.names)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n not in trainable}
    method = cl_method(name, model, step_cfg, opt)
    seen = collections.Counter()
    watch_method(method, model, seen)
    tr = Transcriber(model=model, tokenizer=tok, languages=CL_LANGS, frontend=FrontendConfig(),
                     batch_size=16, bucket_spec=spec, greedy_impl="fused")
    logger = Logger(os.path.join(root, "runs"), run_id=name, use_wandb=False)
    cfg = DriverConfig(batch_size=16, epochs=1, seed=0, n_langs=len(CL_LANGS), bucket_spec=spec)

    # --- the main path: counts reset just before, read just after ---
    reset_training_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sequence(cfg=cfg, model=model, step_cfg=step_cfg, optimizer=opt, method=method,
                       task_data=tasks, tokenizer=tok, logger=logger, transcriber=tr,
                       languages=CL_LANGS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counted_wrappers().items()}
    logger.close()

    steps = step_records(os.path.join(logger.dir, "metrics.jsonl"))
    n_steps, n_imp = len(steps), seen["importance_batches"]
    task2 = [r for r in steps if f"train/train_loss_{CL_LANGS[1]}" in r]
    # RNNT losses (each with its backward): the steps and EWC's Fisher batches;
    # encoder passes: those, MAS's surrogate batches, the LwF teacher's
    # forwards on task 2 and the eval batches; backward passes through the
    # trainable layers: the steps and both importance epochs
    n_losses = n_steps + (n_imp if name == "ewc" else 0)
    encodes = n_steps + n_imp + (len(task2) if name == "lwf" else 0) + tr.counts["encoder_batches"]
    want = {"flash_relpos_mhsa": N_LAYERS * encodes,
            "flash_relpos_mhsa_backward": (N_LAYERS - 12) * (n_steps + n_imp),
            "rnnt_alpha": n_losses, "rnnt_beta": n_losses,
            "joint_fused_forward": n_losses, "joint_fused_backward": n_losses,
            "rnnt_greedy_decode_fused": tr.counts["rnnt_batches"]}
    log(f"  {name}: {wall:.2f} s, {n_steps} steps, {n_imp} importance batches, "
        f"eval batches {dict(tr.counts)}; launches {launches}")
    if n_steps != 4 or len(task2) != 2 or n_imp != (4 if name in ("ewc", "mas") else 0):
        raise AssertionError(f"{name}: {n_steps} steps ({len(task2)} on task 2), "
                             f"{n_imp} importance batches; want 4 (2) and 4 for EWC/MAS")
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != {want}")

    val = res["val"]
    if [len(val[l]) for l in CL_LANGS] != [2, 1]:
        raise AssertionError(f"{name}: val records per language "
                             f"{[len(val[l]) for l in CL_LANGS]}, want [2, 1]")
    if not all(math.isfinite(v) for recs in val.values() for r in recs for v in r.values()):
        raise AssertionError(f"{name}: a non-finite WER in {val}")
    matrices = {}
    for metric in ("rnnt_wer", "ctc_wer"):
        # row i holds each language's i-th record: [[hi@1, bn@2], [hi@2, nan]]
        perf, _ = compute_perf_matrix(val, metric)
        if perf.shape != (2, 2) or int(np.isfinite(perf).sum()) != 3:
            raise AssertionError(f"{name}: {metric} matrix {perf.tolist()}")
        matrices[metric] = perf.tolist()
    if not all(math.isfinite(v) for r in steps for k, v in r.items()
               if k.startswith("train/") and isinstance(v, float)):
        raise AssertionError(f"{name}: a non-finite training value in {steps}")
    last = task2[-1]
    lang2 = CL_LANGS[1]
    checks = {"ewc": ["penalty_gnorm"], "mas": ["penalty"], "lwf": ["rnnt_kd", "ctc_kd"]}
    aux = {k: last[f"train/{k}_{lang2}"] for k in checks.get(name, [])}
    if not all(math.isfinite(v) and v > 0 for v in aux.values()):
        raise AssertionError(f"{name}: task-2 terms {aux} must be finite and > 0")
    if name == "lwf" and seen["teachers_checked"] != 1:
        raise AssertionError("lwf: the task-1 teacher was not checked")
    for n, p in model.named_parameters():
        if n in frozen and not torch.equal(p, frozen[n]):
            raise AssertionError(f"{name}: frozen parameter {n} changed")
    files = ["bwt_curves.json"] + [f"model_{l}.npz" for l in CL_LANGS]
    missing = [f for f in files if not os.path.exists(os.path.join(logger.dir, f))]
    if missing:
        raise AssertionError(f"{name}: not written: {missing}")
    log(f"  {name}: val rnnt WER {matrices['rnnt_wer']}, ctc WER {matrices['ctc_wer']}; "
        f"task-2 terms {aux}; {len(frozen)} frozen parameters bit-unchanged; BatchNorm "
        f"statistics kept by {n_imp} importance batches and {seen['teachers_checked']} "
        "teacher(s)")
    out = {"wall_s": wall, "steps": n_steps, "importance_batches": n_imp,
           "eval_batches": dict(tr.counts), "launches": launches, "val": matrices,
           "task2_terms": aux, "losses": [r[k] for r in steps for k in r
                                          if k.startswith("train/train_loss_")]}
    del model, opt, method, tr
    torch.cuda.empty_cache()
    return out, launches


def capture_joint_inputs(step, batch):
    """One step with the joint kernels' wrappers recording their arguments
    (outside any counted run)."""
    import torch

    from indic_cl_asr_torch.ops import joint_fused as J

    seen = {}
    originals = (J.joint_fused_forward, J.joint_fused_backward)

    def fwd(*a, **kw):
        seen["fwd"] = (a, kw)
        return originals[0](*a, **kw)

    def bwd(*a, **kw):
        seen["bwd"] = (a, kw)
        return originals[1](*a, **kw)

    # the wrapped functions count their launches on the module's name
    fwd.launches = bwd.launches = 0
    J.joint_fused_forward, J.joint_fused_backward = fwd, bwd
    try:
        step(batch, torch.Generator().manual_seed(77))
    finally:
        J.joint_fused_forward, J.joint_fused_backward = originals
    torch.cuda.synchronize()
    return seen


def cl_step_setup(dev, tasks, tok, spec):
    """The flagship CL model's train steps under rnnt_impl "pallas" and
    "xla", one B16 batch of the first language on the card, a host
    generator, and one warm-up step of each."""
    import dataclasses

    import torch

    from indic_cl_asr_torch.data.pipeline import BatchPipeline
    from indic_cl_asr_torch.train.step import batch_to_device_dict, make_train_step

    model, opt, step_cfg = cl_setup(dev)
    train = {impl: make_train_step(model, dataclasses.replace(step_cfg, rnnt_impl=impl), opt,
                                   device=dev) for impl in ("pallas", "xla")}
    host = next(iter(BatchPipeline(tasks[CL_LANGS[0]].train, tok, CL_LANGS, 16, spec=spec)))
    batch = batch_to_device_dict(host, dev)
    gen = torch.Generator().manual_seed(0)
    for impl in train:
        train[impl](batch, gen)  # warm-up
    return model, opt, train, host, batch, gen


def step_peak_bytes(train, batch, gen):
    """Device memory of one step of each of ``train``'s steps: allocated
    before it and the peak over it (``max_memory_allocated``), in bytes."""
    import torch

    out = {}
    for impl, step in train.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(batch, gen)
        torch.cuda.synchronize()
        out[impl] = {"before": before, "peak": torch.cuda.max_memory_allocated()}
    return out


def time_cl_step(dev, rec, tasks, tok, spec, steps=5):
    """ms per step of one flagship batch under rnnt_impl "pallas" and
    "xla", in turns (pallas, xla, xla, pallas), each step's peak memory,
    one profiled step of each, and the joint kernels' inputs from a pallas
    step."""
    import torch

    model, opt, train, host, batch, gen = cl_step_setup(dev, tasks, tok, spec)
    mem = step_peak_bytes(train, batch, gen)
    rec["cl_step_memory_bytes"] = mem
    log("  peak memory of a step (allocated before it): " + ", ".join(
        f"{impl} {m['peak'] / 2**30:.3f} GiB ({m['before'] / 2**30:.3f})"
        for impl, m in mem.items()))
    ms = {"pallas": [], "xla": []}
    for impl in ("pallas", "xla", "xla", "pallas"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            train[impl](batch, gen)
        torch.cuda.synchronize()
        ms[impl].append((time.perf_counter() - t0) * 1e3 / steps)
    B, U = host.tokens.shape
    log(f"  one flagship batch (B{B} U{U}), ms/step in turns: pallas {ms['pallas']}, "
        f"xla {ms['xla']}")
    rec["cl_step_ms"] = ms
    rec["cl_step_profile"] = {}
    for impl in ("pallas", "xla"):
        log(f"  rnnt_impl={impl!r}:")
        rec["cl_step_profile"][impl] = profile_step(train[impl], batch, min(ms[impl]), top=12)
    prof = rec["cl_step_profile"]
    log("  step device-busy ms (idle share): " + ", ".join(
        f"{impl} {prof[impl]['device_busy_ms']:.3f} ({prof[impl]['idle_share']:.3f})"
        for impl in ("pallas", "xla")))
    captured = capture_joint_inputs(train["pallas"], batch)
    del model, opt, train
    torch.cuda.empty_cache()
    return captured


def profile_call(fn, calls=3, tries=3):
    """Device ms a launch, by kernel (and copy or fill), over ``calls``
    calls of ``fn`` in one profiler session that traces the card only:
    {name: (ms a launch, launches recorded)}. A session late in a long run
    has come back with the port's kernels missing from some calls, which
    a mean over the recorded launches does not feel; one with no more than
    one name is repeated, up to ``tries`` sessions."""
    from indic_cl_asr_torch.utils.profiling import device_profile

    for _ in range(tries):
        sums = {}
        for k in device_profile(lambda: [fn() for _ in range(calls)], host=False)["kernels"]:
            name = re.sub(r"^void |\(anonymous namespace\)::|<.*|\(.*", "", k["name"]).strip()[:60]
            ms, n = sums.get(name, (0.0, 0))
            sums[name] = (ms + k["device_ms"], n + k["calls"])
        out = {k: (ms / n, n) for k, (ms, n) in sums.items()}
        if len(out) > 1:
            break
    return out


def time_joint_kernels(captured, launches, rec):
    import torch

    from indic_cl_asr_torch.ops import joint_fused as J

    (f, g, w, bias, labels, seed), kw = captured["fwd"]
    lse, dlpb, dlpl = captured["bwd"][0][6:9]
    B, T, H = f.shape
    U1, V1 = g.shape[1], w.shape[2]
    rate = kw["dropout_rate"]
    w32, b32 = w.float(), bias.float()
    plain_fwd = lambda: J._forward_reference(f, g, w32, b32, labels, seed, kw["blank"], rate)  # noqa: E731
    plain_bwd = lambda: J._backward_reference(f, g, w32, b32, labels, seed, kw["blank"],  # noqa: E731
                                              rate, dlpb, dlpl)
    fwd = lambda: J.joint_fused_forward(f, g, w, bias, labels, seed, **kw)  # noqa: E731
    # the training path: the backward on the forward's inputs scratch; and
    # the backward that forms its own
    bwd = lambda: J.joint_fused_backward(f, g, w, bias, labels, seed, lse, dlpb, dlpl,  # noqa: E731
                                         inputs=inputs, **kw)
    bwd_own = lambda: J.joint_fused_backward(f, g, w, bias, labels, seed, lse, dlpb, dlpl,  # noqa: E731
                                             **kw)
    with torch.no_grad():
        kb, kl, _, inputs = fwd()
        # against the forward evaluated exactly (f64 head and sums)
        pb, pl = J._forward_reference(f, g, w.double(), bias.double(), labels, seed,
                                      kw["blank"], rate)
        err_f = max((kb - pb).abs().max().item(), (kl - pl).abs().max().item())
        grads = bwd()
        # the plain version's f32 sums rounded to the kernel's output dtypes
        err_b = max((a.float() - b.to(a.dtype).float()).abs().max().item()
                    for a, b in zip(grads, plain_bwd()))
        fwd_ms = cuda_ms(fwd, iters=10)
        bwd_ms = cuda_ms(bwd, iters=5)
        bwd_own_ms = cuda_ms(bwd_own, iters=5)
        fwd_plain = cuda_ms(plain_fwd, iters=3, warmup=1)
        bwd_plain = cuda_ms(plain_bwd, iters=3, warmup=1)
    parts = {"forward": profile_call(fwd), "backward": profile_call(bwd)}
    rec["joint_fused_profile_ms"] = parts
    for name, p in parts.items():
        busy = sum(ms for ms, _ in p.values())
        log(f"  joint_fused_{name}, profiled: ms a launch (share of their sum {busy:.4f} ms; "
            f"launches recorded): " + ", ".join(
                f"{k} {ms:.4f} ({ms / busy:.3f}; {n})"
                for k, (ms, n) in sorted(p.items(), key=lambda kv: -kv[1][0])))
    rec["joint_fused_ptxas"] = {
        k: ptxas_lines("joint_fused", k)
        for k in ("joint_form_kernel", "joint_logits_lse_kernel", "joint_dlogits_dx_kernel",
                  "joint_dw_db_kernel")}
    for k, v in rec["joint_fused_ptxas"].items():
        log(f"  {k}: {v}")
    rec["joint_fused_pair_ms"] = fwd_ms + bwd_ms
    rec["joint_fused_backward_own_inputs_ms"] = bwd_own_ms
    log(f"  joint forward + backward a call {fwd_ms + bwd_ms:.4f} ms; the backward forming "
        f"its own inputs {bwd_own_ms:.4f} ms (on the forward's {bwd_ms:.4f} ms)")
    lines = []
    for name, ms, plain, err, backward, site in (
            ("joint_fused_forward", fwd_ms, fwd_plain, err_f, False, 201),
            ("joint_fused_backward", bwd_ms, bwd_plain, err_b, True, 256)):
        nbytes, flops = J.work(B, T, U1, H, V1, itemsize=f.element_size(), backward=backward)
        b_ms, b_by = bound_ms(nbytes, flops)
        f32_ms = flops / PEAK_F32_FLOPS * 1e3
        # the products as the kernels run them: TF32 passes of split operands
        passes = J.TF32_PASSES["backward" if backward else "forward"][f.element_size()]
        tf32_ms = passes * 2 * B * T * U1 * H * V1 / PEAK_TF32_FLOPS * 1e3
        lines.append({
            "name": name, "route": "cuda",
            "source": "indic_cl_asr_torch/csrc/joint_fused.cu",
            "replaces": f"indic_cl_asr_tpu/ops/joint_fused_pallas.py:{site}",
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        rec[f"{name}_f32_core_bound_ms"] = f32_ms
        rec[f"{name}_tf32_bound_ms"] = tf32_ms
        log(f"  {name} B{B} T{T} U+1 {U1} H{H} V+1 {V1} {str(f.dtype).split('.')[-1]} "
            f"(dropout {rate}): {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {nbytes} B, {flops} flop; {tf32_ms:.4f} ms for the {passes} TF32 "
            f"passes of split operands it runs at 495 TFLOP/s, {f32_ms:.4f} ms at the f32 "
            f"CUDA-core rate), max abs err {err:.3e}")
    return lines


def run_cl(dev, rec, tasks, tok):
    """Phase 8: the CL sequence for every method over ``make_cl_data``'s
    tasks, then the step and joint kernel timings. Returns the kernels'
    lines."""
    from indic_cl_asr_torch.data.pipeline import BucketSpec

    import shutil

    root = os.path.join(ROOT, "build", "chip_smoke", "cl")
    shutil.rmtree(os.path.join(root, "runs"), ignore_errors=True)  # the logs append
    spec = BucketSpec(boundaries_sec=(4.0, 8.0), max_tokens=(64, 128))
    rec["cl"], total = {}, {}
    for name in CL_METHODS:
        rec["cl"][name], launches = run_cl_method(dev, name, tasks, tok, spec, root)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    rec["cl_launches"] = total
    time_flash_eval_shapes(eval_flash_operands(dev, tasks, tok, spec), rec)
    captured = time_cl_step(dev, rec, tasks, tok, spec)
    return time_joint_kernels(captured, total, rec)


# the command line's manifest splits and the TaskData fields phase 8 fills
CLI_SPLITS = (("train", "train"), ("val", "val_clean"), ("noisy_val", "val_noisy"),
              ("test", "test_clean"), ("noisy_test", "test_noisy"))
REPORT_FAMILY = ("wer_line_plot.pdf", "wer_shaded_plot.pdf", "wer_error_bars_plot.pdf",
                 "bwt_plot.pdf", "wer_box_plot.pdf")
REPORT_PDFS = tuple(
    [f"{d}_{k}.pdf" for d in ("rnnt", "ctc") for k in ("wer_vs_task", "bwt", "box")]
    + [f"{d}/{f}" for d in ("rnnt_benchmark", "ctc_benchmark", "all_comparison_noisy")
       for f in REPORT_FAMILY])


def write_cli_inputs(tasks, tok, root):
    """Phase 8's CL WAVs as the command line's manifests
    ({lang}_{split}.jsonl) and phase 8's tokenizer, each language padded to
    the flagship's 256 pieces as train_tokenizer.py pads, saved as
    tokenizer_dir. Returns the two directories."""
    from indic_cl_asr_torch.data.manifest import write_manifest
    from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer

    mdir, tok_dir = os.path.join(root, "manifests"), os.path.join(root, "tokenizer")
    os.makedirs(mdir, exist_ok=True)
    for lang, data in tasks.items():
        for split, field in CLI_SPLITS:
            write_manifest(os.path.join(mdir, f"{lang}_{split}.jsonl"), getattr(data, field))
    MultilingualTokenizer({
        lang: CharTokenizer(t.vocab + [f"<pad{i}>" for i in range(t.vocab_size, 256)])
        for lang, t in tok.tokenizers_dict.items()}).save(tok_dir)
    return mdir, tok_dir


def eval_batches(entries, batch_size=16):
    """The batches a Transcriber forms over ``entries``: per bucket of the
    default BucketSpec (config.yaml's), ceil(entries / batch_size)."""
    import collections

    from indic_cl_asr_torch.data.pipeline import BucketSpec

    spec = BucketSpec()
    per_bucket = collections.Counter(spec.bucket_of(e.duration) for e in entries)
    return sum(-(-n // batch_size) for n in per_bucket.values())


def last_record(path, key):
    with open(path) as f:
        return [r for r in map(json.loads, f) if key in r][-1][key]


def quiet_main(main, argv):
    """``main(argv)`` with its standard output captured (this script's own
    output ends in the result lines); returns (result, output lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue().splitlines()


def batch_norm_stats_(model, batch, frontend):
    """Store in every BatchNorm the statistics of ``batch`` (the
    BatchNorms in train mode with momentum 0, the rest of the model in
    eval mode), as a trained model holds its data's: the training steps'
    updates (momentum 0.9) then move them little, where from the initial
    (0, 1) they would shift every layer's eval output."""
    import torch

    from indic_cl_asr_torch.audio.features import log_mel_spectrogram
    from indic_cl_asr_torch.models.conformer import BatchNorm

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        mel, mel_lens = log_mel_spectrogram(torch.from_numpy(batch.audio).to(model.device),
                                            torch.from_numpy(batch.audio_len).to(model.device),
                                            frontend)
        model.eval()
        saved = [m.momentum for m in norms]
        for m in norms:
            m.train()
            m.momentum = 0.0
        model.encode(mel, mel_lens)
        for m, momentum in zip(norms, saved):
            m.eval()
            m.momentum = momentum


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_setup(dev, init=None, mesh=None):
    """Phase 9's data-parallel flagship: phase 8's model (bf16, flash
    attention, layers 0-11 frozen, AdamW lr 1e-4) with dropout and dither
    off, so that two ranks and one process draw nothing that differs;
    SpecAugment on, the pallas joint. Seeded weights, or the config and
    weights ``init`` holds (``torch.save({"cfg", "state"})``); split over
    ``mesh``'s model axis (``shard_model``) before AdamW is built."""
    import dataclasses

    import torch

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, flagship_config, init_weights_
    from indic_cl_asr_torch.parallel.sharding import shard_model
    from indic_cl_asr_torch.train.state import make_optimizer
    from indic_cl_asr_torch.train.step import StepConfig

    if init is None:
        cfg = flagship_config(torch.bfloat16, attn_impl="flash", frozen_till=12)
        cfg = dataclasses.replace(cfg, pred_dropout=0.0, joint_dropout=0.0,
                                  encoder=dataclasses.replace(cfg.encoder, dropout=0.0,
                                                              dropout_att=0.0,
                                                              dropout_pre_encoder=0.0))
        model = init_weights_(HybridRNNTCTC(cfg, device=dev), torch.Generator().manual_seed(0))
    else:
        saved = torch.load(init, weights_only=False)
        model = HybridRNNTCTC(saved["cfg"], device=dev)
        model.load_state_dict(saved["state"])
    if mesh is not None:
        shard_model(model, mesh)
    opt = make_optimizer(model, lr=1e-4, weight_decay=0.01,
                         freeze_encoder_till=model.cfg.encoder.frozen_till, device=dev)
    step_cfg = StepConfig(frontend=FrontendConfig(dither=0.0), rnnt_chunk_size=64,
                          uniform_lang_head=True, rnnt_impl="pallas")
    return model, opt, step_cfg


def dp_step_result(model, opt, aux):
    """What the two-rank check compares, on the CPU: the aux losses, every
    parameter, the BatchNorm statistics and the first moment (0.1 x the
    step's summed gradient)."""
    return {"aux": {k: float(v) for k, v in aux.items()},
            "state": {k: v.detach().float().cpu() for k, v in model.state_dict().items()},
            "grad": {n: (m / 0.1).float().cpu() for n, m in zip(opt.names, opt.mu)},
            "trainable": list(opt.names)}


def tp_step_result(model, opt, aux):
    """``dp_step_result`` of a model split over a model axis: the state
    and the first moment gathered whole; and this rank's whole tensors
    (the parameters not split, the statistics) as it holds them."""
    from indic_cl_asr_torch.parallel import sharding as S

    state = S.gather_state(model, opt)
    split = {n for n, p in model.named_parameters() if S.split_of(p) is not None}
    return {"aux": {k: float(v) for k, v in aux.items()},
            "state": {k: v.float().cpu() for k, v in state["model"].items()},
            "grad": {n: (m / 0.1).float().cpu() for n, m in zip(opt.names, state["mu"])},
            "trainable": list(opt.names),
            "whole": {k: v.detach().cpu() for k, v in model.state_dict().items()
                      if k not in split},
            "split": sorted(split)}


# the two-rank check's steps: the saved weights of each, bf16 and f32
DP_INITS = {"bf16": "init.pt", "f32": "init_f32.pt"}


def dp_rank_main(rank, port, root, device) -> int:
    """One rank of phase 9's two-rank check (``chip_smoke.py --dp-rank R
    PORT DIR DEVICE``): gloo on DEVICE (cuda:0) beside the other rank, one
    step on this rank's 8 rows of the saved B16 batch from each of
    ``DP_INITS`` (f32 with TF32 off) on the 2 x 1 mesh; then on the 1 x 2
    mesh one step of each on all 16 rows, the model split (the training
    kernels' launches counted from 0 around each step, the flash
    forward's head counts recorded), and the bf16 one written as a whole
    checkpoint (``save_model``); writes its results to DIR."""
    import torch

    sys.path.insert(0, ROOT)
    from indic_cl_asr_torch.models import conformer as C
    from indic_cl_asr_torch.parallel import distributed as D
    from indic_cl_asr_torch.parallel import sharding as S
    from indic_cl_asr_torch.train.step import make_train_step
    from indic_cl_asr_torch.utils.checkpoint import save_model

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    D.setup_distributed(f"127.0.0.1:{port}", 2, rank, device=dev, backend="gloo")
    mesh = S.make_mesh()
    batch = S.place_batch(torch.load(os.path.join(root, "batch.pt")), mesh, dev)
    out = {"rows": int(batch["audio"].shape[0]), "row0": batch["row0"]}
    for dtype, init in DP_INITS.items():
        model, opt, step_cfg = dp_setup(dev, os.path.join(root, init))
        step = make_train_step(model, step_cfg, opt, device=dev, mesh=mesh)
        S.COUNTS.clear()
        t0 = time.perf_counter()
        aux = step(batch, torch.Generator().manual_seed(0))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[dtype] = dict(dp_step_result(model, opt, aux), step_s=time.perf_counter() - t0,
                          counts=dict(S.COUNTS))
        del model, opt, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    # the model axis: 1 x 2, each rank all 16 rows, the model split
    tp = S.make_mesh(1, 2)
    batch = S.place_batch(torch.load(os.path.join(root, "batch.pt")), tp, dev)
    heads, flash = [], C.flash_relpos_mhsa

    def flash_heads(*a, **k):  # the heads each flash forward runs at
        heads.append(k["n_heads"])
        return flash(*a, **k)

    C.flash_relpos_mhsa = flash_heads
    out["tp"] = {"rows": int(batch["audio"].shape[0]), "row0": batch["row0"],
                 "mesh": (tp.data_rank, tp.model_rank)}
    for dtype, init in DP_INITS.items():
        model, opt, step_cfg = dp_setup(dev, os.path.join(root, init), mesh=tp)
        step = make_train_step(model, step_cfg, opt, device=dev, mesh=tp)
        heads.clear()
        S.COUNTS.clear()
        reset_training_counts()
        t0 = time.perf_counter()
        aux = step(batch, torch.Generator().manual_seed(0))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches, counts = training_counts(), dict(S.COUNTS)  # the step's alone
        out["tp"][dtype] = dict(tp_step_result(model, opt, aux), step_s=step_s,
                                counts=counts, launches=launches,
                                flash_heads=sorted(set(heads)), flash_calls=len(heads))
        if dtype == "bf16":
            save_model(os.path.join(root, "tp_model.pt"), model)
        del model, opt, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    D.barrier("results")
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    D.shutdown()
    return 0


# the two-rank check's bars. In f32 (TF32 off) the two ranks run the same
# kernels on the same rows as one process; only the order of the sums
# differs (each rank sums its rows, the all-reduce adds the shares) and
# the kernels' atomics. So each tensor is held alone to the f32
# one-process step by its distance (``f32_distances``). A fixed bar does
# not know how far reordered f32 sums move a tensor: 4.0e-5 on the worst
# tensor at d64, 3 layers on the CPU, 1.85e-4 at the flagship on the card
# (layer 16's pointwise conv; the median tensor 4.7e-5, the kernels'
# atomics alone 2.2e-6). The witness is two more one-process f32 steps
# from the same weights each moved by one rounding (x (1 ± DP_ULP), signs
# from two seeds): each tensor of the two ranks lies within DP_F32_FACTOR
# x the larger of their distances on the same tensor, plus DP_F32_FLOOR
# for tensors one rounding hardly moves. In the CPU rehearsal the two
# ranks' median tensor sat 2.1x one rounding's (2.1e-5 against 1.0e-5),
# and a BatchNorm whose backward leaves the cotangent unreduced moved the
# depthwise conv bias by 2.7, 140,000x a bar of twice one rounding. The
# parameters are not held to a bar: Adam's first update is about
# ±lr·sign(g) whatever g's size, so the first moment carries the check.
# In bf16 a gradient summed from many cancelling terms (the position and
# CTC biases') keeps little of bf16's 8 bits: the one-process bf16 step's
# gradients lie up to 5.7% (relative L2) from the f32 step's, the two
# ranks' up to 7.1%, on other tensors in each run (an H100 80GB HBM3 at
# 700 W). So in addition the two-rank bf16 step is held to the f32
# one-process step of the same weights and batch: the loss, all gradients
# together (relative L2), the worst gradient (a ZERO_GRADIENT bias's
# relative to its weight's RMS over its size) and the worst BatchNorm
# statistic (relative to 1 + |x|), each within DP_FACTOR x the
# one-process bf16 step's own distance plus a floor (1e-4; gradients
# 1e-3). In both dtypes the frozen parameters stay equal and the two
# ranks hold one model
DP_ULP, DP_F32_FACTOR, DP_F32_FLOOR, DP_FACTOR = 2.0 ** -23, 4.0, 1e-5, 2.0


def f32_distances(a, b) -> dict:
    """Step ``a`` from the f32 step ``b``, tensor by tensor: each
    gradient's (the first moment over 0.1) max |Δ| / (its owner's max|g|
    (ZERO_GRADIENT) + |g|), each BatchNorm statistic's max |Δ| / (1 +
    |x|), and the loss's relative distance (key ``loss``)."""
    out = {n: float(((a["grad"][n] - g).abs() / (grad_scale(n, b["grad"]) + g.abs())).max())
           for n, g in b["grad"].items()}
    out.update({k: float(((a["state"][k] - v).abs() / (1 + v.abs())).max())
                for k, v in b["state"].items() if k.endswith(("running_mean", "running_var"))})
    out["loss"] = abs(a["aux"]["train_loss"] - b["aux"]["train_loss"]) / abs(b["aux"]["train_loss"])
    return out


def rounded_weights_(model, seed=1):
    """Every parameter x (1 ± DP_ULP), the signs drawn from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            sign = torch.randint(0, 2, p.shape, generator=gen).to(p.device) * 2 - 1
            p.mul_(1 + DP_ULP * sign)


def check_two_ranks(dev, rec, tasks, tok):
    """Phase 9's two-rank check: two processes on cuda:0 joined over gloo
    each take 8 rows of one B16 batch of phase 8's data and step the
    flagship once in bf16 and once in f32 (``dp_setup``, ``DP_INITS``);
    against this process's one-process steps of the whole batch (bf16
    once; f32 twice, the run-to-run spread of the kernels' atomics, and
    twice from weights moved by one rounding, the witness), each f32
    tensor alone and the bf16 step in aggregate (the bars above); the two
    ranks' models against each other (equal)."""
    import dataclasses
    import shutil

    import torch

    from indic_cl_asr_torch.data.pipeline import BatchPipeline, BucketSpec
    from indic_cl_asr_torch.train.step import batch_to_device_dict, make_train_step

    t_check = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke", "dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    spec = BucketSpec(boundaries_sec=(4.0, 8.0), max_tokens=(64, 128))
    host = next(iter(BatchPipeline(tasks[CL_LANGS[0]].train, tok, CL_LANGS, 16, spec=spec)))
    torch.save(batch_to_device_dict(host, "cpu"), os.path.join(root, "batch.pt"))
    model, _, _ = dp_setup(dev)
    cfg, state = model.cfg, model.state_dict()
    torch.save({"cfg": cfg, "state": state}, os.path.join(root, DP_INITS["bf16"]))
    f32 = dataclasses.replace(cfg, dtype=torch.float32,
                              encoder=dataclasses.replace(cfg.encoder, dtype=torch.float32))
    torch.save({"cfg": f32, "state": state}, os.path.join(root, DP_INITS["f32"]))
    del model, state
    torch.cuda.empty_cache()
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                               str(port), root, str(dev)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=300)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"two-rank check: rank {r} exited {p.returncode}:\n"
                                 f"{errs[r][-3000:]}")
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    ones = []
    for dtype, rounding in (("bf16", 0), ("f32", 0), ("f32", 0), ("f32", 1), ("f32", 2)):
        model, opt, step_cfg = dp_setup(dev, os.path.join(root, DP_INITS[dtype]))
        if rounding:
            rounded_weights_(model, seed=rounding)
        aux = make_train_step(model, step_cfg, opt, device=dev)(
            batch_to_device_dict(host, dev), torch.Generator().manual_seed(0))
        ones.append(dp_step_result(model, opt, aux))
        del model, opt
    torch.cuda.empty_cache()

    out = compare_two_ranks(ranks, ones, t_check)
    rec["two_ranks"] = out
    log(f"  two ranks (gloo on cuda:0, 8 rows each of B16, rnnt_impl 'pallas', SpecAugment on; "
        f"bf16 and f32): {json.dumps(out)}")
    if not (out["ranks_equal"] and out["rows"] == [8, 8] and out["f32"]["worst_ratio"] <= 1.0
            and max(out["bf16_ratio_to_bar"].values()) <= 1.0 and not out["frozen_changed"]):
        raise AssertionError(f"two ranks against one process: {out}")
    tp = compare_two_ranks([r["tp"] for r in ranks], ones, t_check)
    rec["model_axis"] = tp = check_model_axis(dev, ranks, tp, tok, tasks, root)
    log(f"  model axis (1 x 2: gloo on cuda:0, each rank all 16 rows, the encoder split over "
        f"4 heads a rank, heads and prediction net gathered at use; bf16 and f32): "
        f"{json.dumps(tp)}")
    if not (tp["ranks_equal"] and tp["whole_equal"] and tp["rows"] == [16, 16]
            and tp["f32"]["worst_ratio"] <= 1.0
            and max(tp["bf16_ratio_to_bar"].values()) <= 1.0 and not tp["frozen_changed"]
            and tp["flash_heads"] == [4] and tp["checkpoint_equal"] and tp["decodes_equal"]):
        raise AssertionError(f"the model axis against one process: {tp}")
    # the training kernels' launches of rank 0's two split steps (the main
    # path's model-axis entry)
    rec["model_axis_launches"] = {k: sum(tp["launches"][d][k] for d in DP_INITS)
                                  for k in tp["launches"]["bf16"]}
    rec["two_ranks"]["check_s"] = time.perf_counter() - t_check
    log(f"  phase 9's two-rank checks took {rec['two_ranks']['check_s']:.1f} s")
    return out


def compare_two_ranks(ranks, ones, t_check):
    """Two ranks' steps (``ranks[r][dtype]``) against this process's
    one-process steps ``ones`` (bf16; f32 twice; f32 from weights moved by
    one rounding, twice): each f32 tensor alone and the bf16 step in
    aggregate (the bars above); the ranks' models against each other."""
    import torch

    one, truth, truth_again = ones[:3]

    def grad_norm(g, name):
        """‖g‖ of ``name``'s gradient owner, over ``name``'s size."""
        w = g[gradient_owner(name)]
        return max(float(w.norm()) * (g[name].numel() / w.numel()) ** 0.5, 1e-30)

    def distances(a):
        """``a``'s step from the f32 step's, relative: the loss, all
        gradients together, the worst gradient and BatchNorm statistic."""
        grads = {n: float((a["grad"][n] - g).norm()) / grad_norm(truth["grad"], n)
                 for n, g in truth["grad"].items()}
        worst = max(grads, key=grads.get)
        stats = {k: float(((a["state"][k] - v).abs() / (1 + v.abs())).max())
                 for k, v in truth["state"].items()
                 if k.endswith(("running_mean", "running_var"))}
        diff = torch.cat([(a["grad"][n] - g).flatten() for n, g in truth["grad"].items()])
        total = torch.cat([g.flatten() for g in truth["grad"].values()])
        return {"loss": abs(a["aux"]["train_loss"] - truth["aux"]["train_loss"])
                / abs(truth["aux"]["train_loss"]),
                "grads": float(diff.norm() / total.norm()), "worst_grad": grads[worst],
                "worst_grad_name": worst, "worst_stat": max(stats.values())}

    two, again = f32_distances(ranks[0]["f32"], truth), f32_distances(truth_again, truth)
    rounded = [f32_distances(a, truth) for a in ones[3:]]
    rounded = {k: max(r[k] for r in rounded) for k in two}
    f32_ratio = {k: two[k] / (DP_F32_FACTOR * rounded[k] + DP_F32_FLOOR) for k in two}
    order = sorted(f32_ratio, key=f32_ratio.get)

    def summary(d):
        worst = max(d, key=d.get)
        return {"worst": d[worst], "worst_name": worst, "median": sorted(d.values())[len(d) // 2]}

    f32_out = {"worst_ratio": max(f32_ratio.values()),
               "ratio_to_bar": summary(f32_ratio), "next_names": order[-4:-1],
               "two_ranks": summary(two), "one_process_again": summary(again),
               "one_rounding": summary(rounded),
               "worst_ratio_detail": {"two_ranks": two[order[-1]],
                                      "one_rounding": rounded[order[-1]]}}
    two_d, one_d = distances(ranks[0]["bf16"]), distances(one)
    ratio = {k: two_d[k] / (DP_FACTOR * one_d[k] + (1e-3 if "grad" in k else 1e-4))
             for k in ("loss", "grads", "worst_grad", "worst_stat")}
    trainable = set(one["trainable"])
    frozen = [f"{dtype} {k}" for dtype, want in (("bf16", one), ("f32", truth))
              for k, v in want["state"].items() if k not in trainable
              and not k.endswith(("running_mean", "running_var"))
              and not torch.equal(ranks[0][dtype]["state"][k], v)]
    out = {"f32": f32_out,
           "bf16_from_f32": {"two_ranks": two_d, "one_process": one_d},
           "bf16_ratio_to_bar": ratio,
           "loss": {"two_ranks_bf16": ranks[0]["bf16"]["aux"]["train_loss"],
                    "one_process_bf16": one["aux"]["train_loss"],
                    "two_ranks_f32": ranks[0]["f32"]["aux"]["train_loss"],
                    "one_process_f32": truth["aux"]["train_loss"]},
           "frozen_changed": len(frozen),
           "ranks_equal": all(torch.equal(v, ranks[1][dtype]["state"][k])
                              for dtype in DP_INITS for k, v in ranks[0][dtype]["state"].items()),
           "rows": [r["rows"] for r in ranks], "row0": [r["row0"] for r in ranks],
           "rank_step_s": {d: [r[d]["step_s"] for r in ranks] for d in DP_INITS},
           "rank_counts": ranks[0]["bf16"]["counts"],
           "bars": {"f32_factor": DP_F32_FACTOR, "f32_floor": DP_F32_FLOOR, "ulp": DP_ULP,
                    "bf16_factor": DP_FACTOR},
           "check_s": time.perf_counter() - t_check}
    return out


def check_model_axis(dev, ranks, out, tok, tasks, root):
    """The 1 x 2 steps' own checks, added to ``compare_two_ranks``'s: the
    whole tensors each rank holds (parameters not split, statistics) bit-
    identical across the ranks, the flash forward's heads a rank, the
    model axis's collectives a step, the training kernels' launches, and
    the checkpoint rank 0 wrote: loaded by one process it equals the
    gathered model, and decodes one eval batch as a model of the gathered
    state does."""
    import torch

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC
    from indic_cl_asr_torch.train.eval import Transcriber
    from indic_cl_asr_torch.utils.checkpoint import load_model

    tp = [r["tp"] for r in ranks]
    out = dict(out, rows=[t["rows"] for t in tp], mesh=[t["mesh"] for t in tp],
               whole_equal=all(
                   torch.equal(v, tp[1][d]["whole"][k])
                   for d in DP_INITS for k, v in tp[0][d]["whole"].items()),
               n_whole=len(tp[0]["bf16"]["whole"]), n_split=len(tp[0]["bf16"]["split"]),
               flash_heads=sorted({h for t in tp for d in DP_INITS for h in t[d]["flash_heads"]}),
               flash_calls={d: tp[0][d]["flash_calls"] for d in DP_INITS},
               launches={d: tp[0][d]["launches"] for d in DP_INITS},
               rank_step_s={d: [t[d]["step_s"] for t in tp] for d in DP_INITS},
               model_axis_a_step={d: {k: v for k, v in tp[0][d]["counts"].items()
                                      if k.startswith("model_")} for d in DP_INITS})
    saved = torch.load(os.path.join(root, DP_INITS["bf16"]), weights_only=False)
    loaded = load_model(os.path.join(root, "tp_model.pt"), HybridRNNTCTC(saved["cfg"], device=dev))
    gathered = HybridRNNTCTC(saved["cfg"], device=dev)
    gathered.load_state_dict(tp[0]["bf16"]["state"])
    out["checkpoint_equal"] = all(torch.equal(v.float().cpu(), tp[0]["bf16"]["state"][k])
                                  for k, v in loaded.state_dict().items())
    entries = tasks[CL_LANGS[0]].val_clean[:16]
    texts = [Transcriber(model=m, tokenizer=tok, languages=CL_LANGS, frontend=FrontendConfig(),
                         batch_size=16).transcribe(entries) for m in (loaded, gathered)]
    out["decodes_equal"] = texts[0] == texts[1]
    out["decoded_nonempty"] = sum(bool(t) for t in texts[0])
    del loaded, gathered
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def time_dp_step(dev, rec, tasks, tok, steps=5):
    """The flagship step (``dp_setup``) on one B16 batch with the group of
    one (``make_mesh()``: its all-reduces) against no group, in turns
    (none, group, group, none, none, group: the host's noise is ~20 ms a
    step), wall ms a step beside one profiled step's device-busy ms and
    idle share; the all-reduces of a step, their bytes and the host ms
    spent issuing them."""
    import torch

    from indic_cl_asr_torch.data.pipeline import BatchPipeline, BucketSpec
    from indic_cl_asr_torch.parallel import sharding as S
    from indic_cl_asr_torch.train.step import batch_to_device_dict, make_train_step
    from indic_cl_asr_torch.utils.profiling import device_profile

    model, opt, step_cfg = dp_setup(dev)
    mesh = S.make_mesh()
    spec = BucketSpec(boundaries_sec=(4.0, 8.0), max_tokens=(64, 128))
    host = next(iter(BatchPipeline(tasks[CL_LANGS[0]].train, tok, CL_LANGS, 16, spec=spec)))
    runs = {"no_group": (make_train_step(model, step_cfg, opt, device=dev),
                         batch_to_device_dict(host, dev)),
            "group_of_one": (make_train_step(model, step_cfg, opt, device=dev, mesh=mesh),
                             S.place_batch(batch_to_device_dict(host, "cpu"), mesh, dev))}
    gen = torch.Generator().manual_seed(0)
    # warm-up: both paths in turns, `steps` steps each twice (one step
    # each left the first timed turn ~100 ms a step slower than the rest)
    for _ in range(2):
        for step, batch in runs.values():
            for _ in range(steps):
                step(batch, gen)
    S.COUNTS.clear()
    for _ in range(steps):
        runs["group_of_one"][0](runs["group_of_one"][1], gen)
    torch.cuda.synchronize()
    per_step = {k: v / steps for k, v in S.COUNTS.items()}
    ms = {k: [] for k in runs}
    for k in ("no_group", "group_of_one", "group_of_one", "no_group", "no_group",
              "group_of_one"):
        step, batch = runs[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch, gen)
        torch.cuda.synchronize()
        ms[k].append((time.perf_counter() - t0) * 1e3 / steps)
    busy = {k: device_profile(lambda: runs[k][0](runs[k][1], gen), host=False)["device_busy_ms"]
            for k in runs}
    median = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    out = {"ms": ms, "median_ms": median,
           "group_minus_none_ms": median["group_of_one"] - median["no_group"],
           "device_busy_ms": busy,
           "idle_share": {k: 1 - busy[k] / min(ms[k]) for k in runs},
           "all_reduces_a_step": per_step["all_reduce"],
           "all_reduce_bytes_a_step": per_step["all_reduce_bytes"],
           "all_reduce_host_ms_a_step": per_step["all_reduce_host_s"] * 1e3}
    rec["dp_step"] = out
    log(f"  data parallel, a flagship step (B16, rnnt_impl 'pallas') with the group of one "
        f"against no group: {json.dumps(out)}")
    del model, opt, runs
    torch.cuda.empty_cache()
    return out


def run_cli(dev, rec, tasks, tok, overrides=()):
    """Phase 9: the command line. Phase 8's WAVs as manifests, the model
    config.yaml gives with --n_langs 2 (the flagship: 17 layers d512 in 8
    heads, bf16, flash attention, layers 0-11 frozen, B16, rnnt_impl
    "xla") with phase 4's emitting weights and its data's BatchNorm
    statistics, saved by save_model; then ``cl_baseline.main`` from that
    init checkpoint (two tasks of two steps), ``transcribe.main`` on the
    run dir (greedy RNNT and CTC, each language's val manifest) and
    ``results.main``. The run takes ``--lr 1e-6``: an Adam step moves every
    trainable weight by about lr, all in step, and at config.yaml's 1e-4
    two steps leave the random model silent (no RNNT hypothesis, and none
    or one CTC hypothesis of 8 a language, in a run on the H100), which
    would make the transcribe check empty. ``overrides`` are more config
    flags (a narrowed rehearsal on the CPU). Returns the launch counts of
    the counted runs."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.data.pipeline import BatchPipeline
    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC
    from indic_cl_asr_torch.parallel import distributed as D
    from indic_cl_asr_torch.parallel import sharding as S
    from indic_cl_asr_torch.scripts import _common as C
    from indic_cl_asr_torch.scripts import cl_baseline, results, transcribe
    from indic_cl_asr_torch.train.eval import Transcriber
    from indic_cl_asr_torch.train.state import trainable_names
    from indic_cl_asr_torch.utils.checkpoint import save_model

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke", "cli")
    shutil.rmtree(root, ignore_errors=True)
    mdir, tok_dir = write_cli_inputs(tasks, tok, root)
    out = os.path.join(root, "runs")
    argv = ["--n_langs", "2", "--dataset.manifest_dir", mdir, "--tokenizer_dir", tok_dir,
            "--output_dir", out, "--use_wandb", "false", "--lr", "1e-6", "--device", dev.type,
            *overrides]
    wall, total = {}, {}

    def count(part, t0):
        torch.cuda.synchronize()
        wall[part] = time.perf_counter() - t0
        launches = {k: w.launches for k, w in counted_wrappers().items()}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return launches

    t0 = time.perf_counter()
    cfg, _ = C.setup(argv)
    langs = C.build_languages(cfg)
    data = C.build_data(cfg, langs)
    tokenizer = C.build_tokenizer(cfg, langs, data)
    model = HybridRNNTCTC(C.build_model_cfg(cfg, tokenizer, langs), device=dev)
    serving_weights_(model, cfg.seed)
    frontend = FrontendConfig(n_mels=cfg.model.n_mels)
    for entries, fit in ((data[langs[0]].train, batch_norm_stats_),
                         (data[langs[0]].val_clean, calibrate_blank_)):
        fit(model, next(iter(BatchPipeline(entries, tokenizer, langs, cfg.batch_size))), frontend)
    init = os.path.join(root, "init.pt")
    save_model(init, model)
    frozen = sorted(set(n for n, _ in model.named_parameters())
                    - set(trainable_names(model, cfg.model.freeze_encoder_till)))
    F, L = cfg.model.freeze_encoder_till, cfg.model.n_layers
    del model
    wall["init_s"] = time.perf_counter() - t0

    # --- the main path: counts reset just before, read just after; a
    # process group of one over NCCL (INDIC_ASR_MULTIHOST=1, --mesh.data 0),
    # destroyed at the end of the phase ---
    group_env = {"INDIC_ASR_MULTIHOST": "1", "INDIC_ASR_COORDINATOR": f"127.0.0.1:{free_port()}",
                 "INDIC_ASR_NUM_PROCESSES": "1", "INDIC_ASR_PROCESS_ID": "0"}
    os.environ.update(group_env)
    # the run's own eval texts, the last of each (utterances, decoder), for
    # transcribe's texts to be held against
    evals, transcribe_entries = {}, Transcriber.transcribe

    def recorded(self, entries, decoder="rnnt"):
        hyps = transcribe_entries(self, entries, decoder)
        evals[(tuple(e.audio_filepath for e in entries), decoder)] = hyps
        return hyps

    reset_training_counts()
    S.COUNTS.clear()
    t0 = time.perf_counter()
    Transcriber.transcribe = recorded
    try:
        res = cl_baseline.main(argv + ["--init_checkpoint", init, "--mesh.data", "0"])
    finally:
        Transcriber.transcribe = transcribe_entries
    launches = count("cl_baseline_s", t0)
    group = {"backend": dist.get_backend(), "world": D.process_count(),
             "all_reduces": S.COUNTS["all_reduce"], "bytes": S.COUNTS["all_reduce_bytes"]}
    (run_dir,) = [os.path.join(out, d) for d in os.listdir(out)]
    steps = step_records(os.path.join(run_dir, "metrics.jsonl"))
    # eval after task t: languages 0..t, val and test, clean and noisy
    rnnt_batches = sum(eval_batches(getattr(data[l], field))
                       for t in range(len(langs)) for l in langs[: t + 1]
                       for field in ("val_clean", "val_noisy", "test_clean", "test_noisy"))
    want = {"flash_relpos_mhsa": L * (len(steps) + 2 * rnnt_batches),
            "flash_relpos_mhsa_backward": (L - F) * len(steps),
            "rnnt_alpha": len(steps), "rnnt_beta": len(steps),
            "joint_fused_forward": 0, "joint_fused_backward": 0,
            "rnnt_greedy_decode_fused": rnnt_batches}
    log(f"  cl_baseline: {wall['cl_baseline_s']:.2f} s, {len(steps)} steps, "
        f"{rnnt_batches} RNNT + {rnnt_batches} CTC eval batches; launches {launches}")
    # a step all-reduces each BatchNorm's sums (17), their cotangents in the
    # trainable layers (5), and the gradients with the losses (1)
    group["want_all_reduces"] = (L + (L - F) + 1) * len(steps)
    log(f"  process group (NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}): {group}")
    if len(steps) != 4 or launches != want:
        raise AssertionError(f"cli: {len(steps)} steps (want 4), launches {launches} != {want}")
    if (group["backend"], group["world"]) != ("nccl", 1) or \
            group["all_reduces"] != group["want_all_reduces"]:
        raise AssertionError(f"cli: the run did not step through the group of one: {group}")
    losses = [r[k] for r in steps for k in r if k.startswith("train/train_loss_")]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"cli: a non-finite loss in {losses}")
    seq = os.path.join(run_dir, "sequence")
    with open(os.path.join(seq, "sequence.json")) as f:
        done = json.load(f)["completed_tasks"]
    files = [f"sequence/task_{i}_{l}.pt" for i, l in enumerate(langs)] + [
        f"model_{l}.npz" for l in langs]
    missing = [f for f in files if not os.path.exists(os.path.join(run_dir, f))]
    if done != langs or missing:
        raise AssertionError(f"cli: completed tasks {done}, not written: {missing}")
    before = torch.load(init, weights_only=True, mmap=True)["model"]
    after = torch.load(os.path.join(run_dir, files[len(langs) - 1]), weights_only=True,
                       mmap=True)["model"]
    moved = [n for n in frozen if not torch.equal(before[n], after[n])]
    trained = [n for n in after if n in before and n not in frozen
               and not n.endswith(("running_mean", "running_var"))
               and not torch.equal(before[n], after[n])]
    with np.load(os.path.join(run_dir, f"model_{langs[0]}.npz")) as saved:
        saved_frozen = [n for n in saved.files if n in frozen]
    if moved or saved_frozen or not frozen or not trained:
        raise AssertionError(f"cli: frozen parameters changed {moved[:4]} or saved "
                             f"{saved_frozen[:4]} ({len(frozen)} frozen, {len(trained)} "
                             "trained parameters changed)")
    val = {l: {d: res["val"][l][-1][f"{d}_wer"] for d in ("rnnt", "ctc")} for l in langs}
    log(f"  cl_baseline: losses {losses}; last val WERs {val}; {len(frozen)} frozen "
        f"parameters bit-unchanged against the init checkpoint, {len(trained)} trained ones "
        "changed")

    # transcribe on the run dir reproduces the WERs the run logged last
    metrics, wers = os.path.join(run_dir, "metrics.jsonl"), {}
    for lang in langs:
        manifest = os.path.join(mdir, f"{lang}_val.jsonl")
        batches = eval_batches(data[lang].val_clean)
        for dec in ("rnnt", "ctc"):
            reset_training_counts()
            t0 = time.perf_counter()
            hyps, lines = quiet_main(transcribe.main, ["--run", run_dir, "--manifest", manifest,
                                                       "--wer", "--decoder", dec,
                                                       "--device", dev.type])
            launches = count(f"transcribe_{lang}_{dec}_s", t0)
            got = json.loads(lines[-1])["wer"]
            logged = last_record(metrics, f"val/perf_{lang}_{dec}_wer")
            want_tr = {"flash_relpos_mhsa": L * batches,
                       "rnnt_greedy_decode_fused": batches if dec == "rnnt" else 0}
            run_hyps = evals[(tuple(e.audio_filepath for e in data[lang].val_clean), dec)]
            rec.setdefault("cli_texts", {})[f"{lang}_{dec}"] = (
                [e.text for e in data[lang].val_clean], hyps)
            wers[f"{lang}_{dec}"] = {"transcribe": got, "logged": logged,
                                     "non_empty": sum(bool(h.strip()) for h in hyps),
                                     "texts_as_run": hyps == run_hyps,
                                     "launches_as_work": {k: launches[k] for k in want_tr}
                                     == want_tr}
    log(f"  transcribe: {wers}")
    if not all(w["transcribe"] == round(w["logged"], 4) and w["non_empty"]
               and w["texts_as_run"] and w["launches_as_work"] for w in wers.values()):
        raise AssertionError(f"cli: transcribe's WERs against the logged ones, non-empty "
                             f"hypotheses, texts and launches: {wers}")

    t0 = time.perf_counter()
    summaries, _ = quiet_main(results.main, [run_dir, "--out", os.path.join(root, "report")])
    wall["results_s"] = time.perf_counter() - t0
    missing = [p for p in REPORT_PDFS if not os.path.exists(os.path.join(root, "report", p))]
    bwt = {d: v["bwt"] for s in summaries.values() for d, v in s.items()}
    if missing or not all(math.isfinite(b) for v in bwt.values() for b in v):
        raise AssertionError(f"cli: report PDFs missing {missing}, BWT {bwt}")
    main_path_s = time.perf_counter() - t_phase
    log(f"  phase 9 main path {main_path_s:.2f} s (13.0-19.7 s in PERF.md, before the "
        "process group)")
    dp_step = time_dp_step(dev, rec, tasks, tok)
    two_ranks = check_two_ranks(dev, rec, tasks, tok)
    wall["two_ranks_s"] = two_ranks["check_s"]
    wall["main_path_s"] = main_path_s
    for k in group_env:
        os.environ.pop(k)
    D.shutdown()  # phases 10-12 run without a group
    wall["phase_s"] = time.perf_counter() - t_phase
    rec["cli"] = {"wall_s": wall, "launches": total, "steps": len(steps),
                  "rnnt_eval_batches": rnnt_batches, "losses": losses, "wer": wers,
                  "bwt": bwt, "report_pdfs": len(REPORT_PDFS), "group": group,
                  "nccl": ".".join(map(str, torch.cuda.nccl.version())), "dp_step": dp_step}
    print("cli: " + json.dumps({"wall_s": wall, "launches": total}), flush=True)
    return total


# the pretrained path (phase 10): a .nemo written from a port model

def spm_model_bytes(pieces) -> bytes:
    """A SentencePiece ModelProto (unigram) of ``pieces`` [(piece, score,
    type)]: the pieces, a trainer spec and a normalizer spec, as
    tests/test_spm_model.py:make_model_bytes writes them."""
    import struct

    def varint(n):
        out = b""
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    def field_bytes(num, data):
        return varint(num << 3 | 2) + varint(len(data)) + data

    def field_varint(num, val):
        return varint(num << 3) + varint(val)

    blob = b""
    for piece, score, ptype in pieces:
        blob += field_bytes(1, field_bytes(1, piece.encode("utf-8"))
                            + varint(2 << 3 | 5) + struct.pack("<f", score)
                            + field_varint(3, ptype))
    trainer = field_varint(3, 1) + field_varint(35, 0) + field_varint(40, 0)
    norm = field_bytes(1, b"nmt_nfkc") + field_varint(3, 1) + field_varint(4, 1)
    return blob + field_bytes(2, trainer) + field_bytes(3, norm)


def spm_pieces(n=256):
    """``n`` pieces: <unk>, <s>, </s> and single letters, "▁"-prefixed
    letters and letter pairs (the flagship's 256 a language)."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    normal = (list(letters) + ["\u2581" + c for c in letters]
              + [a + b for a in letters for b in letters])[: n - 3]
    return ([("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
            + [(p, -1.0 - 0.01 * i, 1) for i, p in enumerate(normal)])


def nemo_state_dict(model) -> dict:
    """The port model's f32 parameters and BatchNorm statistics under
    NeMo's names and layouts, on the CPU: the inverse of
    models/pretrained.py:convert_nemo_state_dict (heads in LANGUAGE_KEYS'
    order; the LSTM bias whole in bias_ih, bias_hh zero)."""
    import torch

    from indic_cl_asr_torch.models.pretrained import LANGUAGE_KEYS

    cfg = model.cfg
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach().float().cpu()
        parts = name.split(".")
        if name.startswith("encoder.pre_encode.convs."):
            out[f"encoder.pre_encode.conv.{2 * int(parts[3])}.{parts[4]}"] = t
        elif name == "encoder.pre_encode.out.weight":
            C, d = cfg.encoder.conv_channels, cfg.encoder.d_model
            out[name] = t.reshape(d, -1, C).transpose(1, 2).reshape(d, -1)  # (C, F) order
        elif ".conv.pointwise_conv" in name and name.endswith("weight"):
            out[name] = t[:, :, None]  # Conv1d k=1
        elif name == "prediction.embedding":
            out["decoder.prediction.embed.weight"] = t
        elif name.startswith("prediction.lstm."):
            k, leaf = parts[2], parts[3]
            lp = "decoder.prediction.dec_rnn.lstm."
            if leaf == "bias":
                out[f"{lp}bias_ih_l{k}"] = t
                out[f"{lp}bias_hh_l{k}"] = torch.zeros_like(t)
            else:
                out[f"{lp}weight_{leaf[2:]}_l{k}"] = t.t()
        elif name in ("joint.head_kernel", "joint.head_bias"):
            for i, lang in enumerate(LANGUAGE_KEYS[: cfg.n_langs]):
                leaf = "weight" if name.endswith("kernel") else "bias"
                out[f"joint.joint_net.2.{lang}.{leaf}"] = t[i].t() if leaf == "weight" else t[i]
        elif name == "ctc_decoder.kernel":
            out["ctc_decoder.decoder_layers.0.weight"] = t.t()[:, :, None]
        elif name == "ctc_decoder.bias":
            out["ctc_decoder.decoder_layers.0.bias"] = t
        else:
            out[name] = t
    return {k: v.contiguous().clone() for k, v in out.items()}


def nemo_config(cfg) -> dict:
    """model_config.yaml's dict in NeMo's shape (the fields
    model_config_from_nemo maps), its languages LANGUAGE_KEYS' first
    n_langs, each with a ``nemo:`` tokenizer artifact."""
    from indic_cl_asr_torch.models.pretrained import LANGUAGE_KEYS

    e = cfg.encoder
    return {
        "encoder": {
            "feat_in": e.feat_in, "n_layers": e.n_layers, "d_model": e.d_model,
            "n_heads": e.n_heads, "ff_expansion_factor": e.ff_expansion_factor,
            "conv_kernel_size": e.conv_kernel_size, "conv_norm_type": e.conv_norm_type,
            "subsampling_factor": e.subsampling_factor,
            "subsampling_conv_channels": e.subsampling_conv_channels,
            "dropout": e.dropout, "dropout_pre_encoder": e.dropout_pre_encoder,
            "dropout_emb": e.dropout_emb, "dropout_att": e.dropout_att, "xscale": e.xscale,
            "pos_emb_max_len": e.pos_emb_max_len},
        "decoder": {"prednet": {"pred_hidden": cfg.pred_hidden,
                                "pred_rnn_layers": cfg.pred_rnn_layers}},
        "joint": {"num_classes": -1, "jointnet": {"joint_hidden": cfg.joint_hidden,
                                                  "activation": cfg.joint_activation}},
        "aux_ctc": {"decoder": {"num_classes": cfg.vocab_size_total}},
        "tokenizer": {"type": "multilingual", "langs": {
            lang: {"type": "bpe", "model_path": f"nemo:{i:02d}c0ffee_tokenizer.model"}
            for i, lang in enumerate(LANGUAGE_KEYS[: cfg.n_langs])}},
    }


def write_nemo_tar(path, config: dict, state_dict: dict, members: dict) -> str:
    """A .nemo tar at ``path``: ``config`` as model_config.yaml, the torch
    ``state_dict`` as model_weights.ckpt and ``members`` ({name: bytes},
    the tokenizer artifacts)."""
    import io
    import tarfile

    import torch
    import yaml

    ckpt = io.BytesIO()
    torch.save(state_dict, ckpt)
    files = [("model_config.yaml", yaml.safe_dump(config, sort_keys=False).encode()),
             ("model_weights.ckpt", ckpt.getbuffer()), *members.items()]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with tarfile.open(path, "w") as tar:
        for name, data in files:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def write_nemo(path, model) -> str:
    """``model`` (a port HybridRNNTCTC) as a .nemo tar: model_config.yaml,
    model_weights.ckpt and one SentencePiece model of vocab_per_lang
    pieces a language."""
    config = nemo_config(model.cfg)
    spm = spm_model_bytes(spm_pieces(model.cfg.vocab_per_lang))
    members = {lang["model_path"].removeprefix("nemo:"): spm
               for lang in config["tokenizer"]["langs"].values()}
    return write_nemo_tar(path, config, nemo_state_dict(model), members)


def all_launches():
    """Every kernel's launch count, the beam's included."""
    from indic_cl_asr_torch.ops import beam_fused as bfm

    return {**{k: w.launches for k, w in counted_wrappers().items()},
            "rnnt_beam_search_fused": bfm.rnnt_beam_search_fused.launches}


def reset_all_launches():
    from indic_cl_asr_torch.ops import beam_fused as bfm

    reset_training_counts()
    bfm.rnnt_beam_search_fused.launches = 0


def run_pretrained(dev, rec, entries, tok, langs):
    """Phase 10: the pretrained path at the flagship's width. Phase 4's
    serving model in f32 (its emitting weights; the BatchNorm statistics of
    one of its data's batches, the blank biases calibrated after them)
    written as a .nemo with twelve SentencePiece models of 256 pieces;
    ``restore_pretrained`` on the card (bit-equal parameters and
    statistics, the config equal to the source's); ``transcribe.main
    --nemo`` per decoder on phase 4's WAVs as a manifest under the
    checkpoint's key "hi" (texts equal to a Transcriber over the source
    with the restored tokenizer); ``eval_pretrained.main`` on the same WAVs
    as the test split. Its languages come from config.yaml (the first
    ``n_langs`` of its names: "hindi"), which the checkpoint's tokenizer
    does not know, so it takes ``--local_tokenizer`` (phase 4's "hindi"
    tokenizer padded to 256 pieces) and its records must equal the WER of
    a Transcriber over the source with that tokenizer. Every main's
    launches are counted: flash 17 x the encoded batches, the greedy decode
    one per RNNT batch, every other kernel none. Then the f32 flash forward
    and greedy decode are timed at the long bucket's batch. Returns the
    counted runs' launches."""
    import dataclasses
    import shutil

    import torch

    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.audio.io import load_audio
    from indic_cl_asr_torch.data.manifest import write_manifest
    from indic_cl_asr_torch.data.pipeline import BucketSpec, _assemble
    from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer
    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, flagship_config
    from indic_cl_asr_torch.models.nemo_ingest import restore_pretrained
    from indic_cl_asr_torch.ops import decode_fused as dfm
    from indic_cl_asr_torch.ops import flash_mhsa as fm
    from indic_cl_asr_torch.scripts import eval_pretrained, transcribe
    from indic_cl_asr_torch.train.eval import Transcriber
    from indic_cl_asr_torch.train.metrics import wer

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke", "pretrained")
    shutil.rmtree(root, ignore_errors=True)
    wall, total = {}, {}
    frontend = FrontendConfig()
    spec = BucketSpec(boundaries_sec=(4.0, 8.0), max_tokens=(64, 128))
    long = [e for e in entries if spec.bucket_of(e.duration) == 1][:16]
    lang_index = {l: i for i, l in enumerate(langs)}
    long_batch = _assemble(long, len(long), 1, spec, tok, lang_index, 0, load_audio, None)

    # 1. the source model and its .nemo
    t0 = time.perf_counter()
    src = HybridRNNTCTC(flagship_config(torch.float32, attn_impl="flash"), device=dev)
    serving_weights_(src, seed=0)
    batch_norm_stats_(src, long_batch, frontend)
    biases = calibrate_blank_(src, long_batch, frontend)
    nemo = write_nemo(os.path.join(root, "flagship.nemo"), src)
    wall["write_s"] = time.perf_counter() - t0
    size = os.path.getsize(nemo)

    # 2. restore on the card
    timings = {}
    t0 = time.perf_counter()
    model, mcfg, ptok = restore_pretrained(nemo, os.path.join(root, "spm"), device=dev,
                                           timings=timings)
    wall["restore_s"] = time.perf_counter() - t0
    got, want = model.state_dict(), src.state_dict()
    unequal = sorted(n for n in want if n not in got or not torch.equal(got[n], want[n]))
    if unequal or set(got) != set(want) or mcfg != src.cfg:
        raise AssertionError(f"pretrained: restored tensors differ {unequal[:4]} "
                             f"(of {len(want)}), config {mcfg} != {src.cfg}")
    log(f"  .nemo {size} B written in {wall['write_s']:.2f} s; restored in "
        f"{wall['restore_s']:.2f} s {timings}: {len(want)} tensors bit-equal, config equal, "
        f"tokenizer languages {ptok.langs}, blank biases {biases}")

    def count(part, t0):
        torch.cuda.synchronize()
        wall[part] = time.perf_counter() - t0
        launches = all_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return launches

    def source_hyps(tokenizer, languages, es, decoder):
        tr = Transcriber(model=src, tokenizer=tokenizer, languages=languages,
                         frontend=frontend, batch_size=16, bucket_spec=BucketSpec())
        return tr.transcribe(es, decoder)

    # 3. transcribe --nemo, the manifest under the checkpoint's key
    hi = [dataclasses.replace(e, lang="hi") for e in entries]
    manifest = os.path.join(root, "hi.jsonl")
    write_manifest(manifest, hi)
    batches = eval_batches(hi)
    checks = {}
    for dec in ("rnnt", "ctc"):
        reset_all_launches()
        t0 = time.perf_counter()
        hyps, lines = quiet_main(transcribe.main, ["--nemo", nemo, "--manifest", manifest,
                                                   "--decoder", dec, "--wer",
                                                   "--device", dev.type])
        launches = count(f"transcribe_{dec}_s", t0)
        ref = source_hyps(ptok, ptok.langs, hi, dec)
        want_l = {k: 0 for k in launches}
        want_l["flash_relpos_mhsa"] = N_LAYERS * batches
        want_l["rnnt_greedy_decode_fused"] = batches if dec == "rnnt" else 0
        checks[f"transcribe_{dec}"] = {
            "texts_as_source": hyps == ref, "non_empty": sum(bool(h.strip()) for h in hyps),
            "wer": json.loads(lines[-1])["wer"], "launches": launches,
            "launches_as_work": launches == want_l}

    # 4. eval_pretrained on the same WAVs as the test split
    mdir = os.path.join(root, "manifests")
    os.makedirs(mdir)
    for split, _ in CLI_SPLITS:
        write_manifest(os.path.join(mdir, f"hindi_{split}.jsonl"), entries)
    local = os.path.join(root, "tokenizer")
    hindi = tok.tokenizers_dict["hindi"]
    local_tok = MultilingualTokenizer({"hindi": CharTokenizer(
        hindi.vocab + [f"<pad{i}>" for i in range(hindi.vocab_size, 256)])})
    local_tok.save(local)
    reset_all_launches()
    t0 = time.perf_counter()
    records, _ = quiet_main(eval_pretrained.main, [
        "--nemo", nemo, "--dataset.manifest_dir", mdir, "--n_langs", "1",
        "--local_tokenizer", local, "--split", "test", "--device", dev.type])
    launches = count("eval_pretrained_s", t0)
    want_l = {k: 0 for k in launches}
    want_l["flash_relpos_mhsa"] = N_LAYERS * 2 * batches
    want_l["rnnt_greedy_decode_fused"] = batches
    refs = [e.text for e in entries]
    want_r = [{"lang": "hindi", "decoder": dec, "split": "test",
               "wer": round(float(wer(refs, source_hyps(local_tok, ["hindi"], entries, dec))),
                            4), "n": len(entries)} for dec in ("rnnt", "ctc")]
    checks["eval_pretrained"] = {"records": records, "records_as_source": records == want_r,
                                 "launches": launches, "launches_as_work": launches == want_l}
    log(f"  pretrained path: {checks}")
    bad = [k for k, c in checks.items()
           if not c["launches_as_work"] or not c.get("records_as_source", True)
           or not c.get("texts_as_source", True) or c.get("non_empty", 1) == 0]
    if bad:
        raise AssertionError(f"pretrained: {bad} failed: {checks}")

    # 5. the f32 kernels at the long bucket's batch, on the restored model
    inputs = capture_main_path_inputs(model, frontend, long_batch)
    q, k, v, p, u, vb, lens = inputs["flash"]
    B, T, E = q.shape
    dargs = (inputs["f_proj"], inputs["enc_lens"], inputs["lang"], model)
    # bound_ms takes f32 work at the bf16 tensor-core peak, as the joint's
    # f32 rows do; f32_core_bound_ms is the same work at the CUDA-core rate
    with torch.inference_mode():
        nbytes, flops = fm.work(B, T, E, lens.cpu(), itemsize=4)
        b_ms, b_by = bound_ms(nbytes, flops)
        f32 = {"flash_relpos_mhsa": {
            "ms": cuda_ms(lambda: fm.flash_relpos_mhsa(q, k, v, p, u, vb, lens, n_heads=8)),
            "plain_ms": cuda_ms(lambda: fm.flash_relpos_mhsa_reference(
                q, k, v, p, u, vb, lens, n_heads=8)),
            "bound_ms": b_ms, "bound_by": b_by,
            "f32_core_bound_ms": bound_ms(nbytes, flops, PEAK_F32_FLOPS)[0],
            "shape": [B, T, E]}}
        dfm.reset_counts()
        ms = cuda_ms(lambda: dfm.rnnt_greedy_decode_fused(*dargs), iters=5, warmup=0)
        work = {k_: v_ // 5 if k_ in ("joint_evals", "lstm_steps") else v_
                for k_, v_ in dfm.work_counts().items()}
        nbytes, flops = dfm.work(B, inputs["f_proj"].shape[1], inputs["f_proj"].shape[2],
                                 640, 257, work["joint_evals"], work["lstm_steps"], itemsize=4)
        b_ms, b_by = bound_ms(nbytes, flops)
        f32["rnnt_greedy_decode_fused"] = {
            "ms": ms, "plain_ms": cuda_ms(lambda: dfm.rnnt_greedy_decode_fused_reference(
                *dargs), iters=2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "f32_core_bound_ms": bound_ms(nbytes, flops, PEAK_F32_FLOPS)[0], "work": work}
    del model, inputs, src
    torch.cuda.empty_cache()
    wall["phase_s"] = time.perf_counter() - t_phase
    rec["pretrained"] = {"wall_s": wall, "restore_s": timings, "nemo_bytes": size,
                         "checks": checks, "launches": total, "f32": f32}
    log(f"  f32 kernels at B{B} T{T}: {f32}")
    print("pretrained: " + json.dumps({"wall_s": wall, "restore_s": timings,
                                        "launches": total}), flush=True)
    return total, f32

def run_streaming(dev, rec, entries, overrides=()):
    """Phase 11: the streaming path at the flagship's width and depth. The
    model config.yaml gives with ``--n_langs 12 --mixed_precision false
    --model.causal_conv true --model.att_context_left 70
    --model.att_context_right 0`` (17 layers d512 in 8 heads, conv kernel
    31, x4, 257-wide heads, flash attention; f32, where the decode is
    token-exact), phase 4's emitting weights (``serving_weights_``, then
    ``calibrate_blank_`` on this model), on phase 4's 4.5-8 s bucket (B16;
    its mel zero-padded to a multiple of the 64-frame chunk). Checks, each
    on every row's valid frames: (a) ``stream_full_utterance_cached``
    (chunk 64) equals the offline ``encode`` within atol 2e-4 + rtol 1e-3
    (the JAX tests' bar); (b) ``stream_full_utterance`` (chunk 64, window
    1024 mel: the utterances never slide out of it) equals it too, with 17
    flash launches a window; (c) ``StreamingASR`` with ``valid_mel`` on the
    rows' last chunks gives the fused greedy decode's offline tokens, row
    for row; (d) a run dir saved for this model (config.json, tokenizer/,
    sequence/task_0_hindi.pt as ``save_task`` writes its model entry):
    ``stream_demo.main`` on 2 of the WAVs prints the final texts
    ``transcribe.main`` gives offline. Times the cache-aware step a chunk
    at B1 and B16 (and the real-time factor: a chunk is 0.64 s) and the
    windowed step, in f32 and once in bf16 (config.yaml's dtype, no token
    check). ``overrides`` are more config flags (a narrowed rehearsal on
    the CPU). Returns the counted runs' launches."""
    import shutil

    import torch
    import torch.nn.functional as F

    from indic_cl_asr_torch.audio.features import FrontendConfig, log_mel_spectrogram
    from indic_cl_asr_torch.audio.io import load_audio
    from indic_cl_asr_torch.data.pipeline import BucketSpec, _assemble
    from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer
    from indic_cl_asr_torch.models import streaming as S
    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC
    from indic_cl_asr_torch.ops import decode_fused as dfm
    from indic_cl_asr_torch.ops import flash_mhsa as fm
    from indic_cl_asr_torch.scripts import _common as C
    from indic_cl_asr_torch.scripts import stream_demo, transcribe
    from indic_cl_asr_torch.utils.checkpoint import save_model

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke", "streaming")
    shutil.rmtree(root, ignore_errors=True)
    run = os.path.join(root, "run")
    argv = ["--n_langs", "12", "--mixed_precision", "false", "--model.causal_conv", "true",
            "--model.att_context_left", "70", "--model.att_context_right", "0",
            "--output_dir", root, "--use_wandb", "false", "--device", dev.type, *overrides]
    cfg, _ = C.setup(argv)
    langs = C.build_languages(cfg)
    # phase 4's hindi char tokenizer padded to 256 pieces, for every language
    hindi = CharTokenizer.train([" ".join(WORDS["hindi"])] * 4)
    tok = MultilingualTokenizer({l: CharTokenizer(
        hindi.vocab + [f"<pad{i}>" for i in range(hindi.vocab_size, 256)]) for l in langs})
    model_cfg = C.build_model_cfg(cfg, tok, langs)
    enc_cfg = model_cfg.encoder
    L, A = enc_cfg.n_layers, enc_cfg.att_context_size[0]
    model = HybridRNNTCTC(model_cfg, device=dev)
    serving_weights_(model, seed=0)
    frontend = FrontendConfig(n_mels=enc_cfg.feat_in)
    spec = BucketSpec(boundaries_sec=(4.0, 8.0), max_tokens=(64, 128))
    long = [e for e in entries if spec.bucket_of(e.duration) == 1][:16]
    batch = _assemble(long, len(long), 1, spec, tok, {l: i for i, l in enumerate(langs)}, 0,
                      load_audio, None)
    biases = calibrate_blank_(model, batch, frontend)
    os.makedirs(os.path.join(run, "sequence"))
    with open(os.path.join(run, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2, default=str)
    tok.save(os.path.join(run, "tokenizer"))
    save_model(os.path.join(run, "sequence", "task_0_hindi.pt"), model)
    CH = 64
    with torch.inference_mode():
        mel, mel_lens = log_mel_spectrogram(torch.from_numpy(batch.audio).to(dev),
                                            torch.from_numpy(batch.audio_len).to(dev),
                                            frontend)
        mel = F.pad(mel, (0, -mel.shape[-1] % CH))
        lang = torch.from_numpy(batch.lang_ids).to(dev)
    B, _, T_mel = mel.shape
    n_chunks = T_mel // CH
    wall, total, checks = {}, {}, {}

    def count(part):
        launches = all_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        checks.setdefault("launches", {})[part] = launches
        return launches

    # the offline yardstick: encode and the fused greedy decode
    reset_all_launches()
    with torch.inference_mode():
        f_off, enc_lens = model.encode(mel, mel_lens)
        want_ids, want_lens = dfm.rnnt_greedy_decode_fused(
            model.joint_project_enc(f_off), enc_lens, lang, model)
    launches = count("offline")
    if launches["flash_relpos_mhsa"] != L or launches["rnnt_greedy_decode_fused"] != 1:
        raise AssertionError(f"streaming: offline launches {launches}")
    valid = torch.arange(f_off.shape[1], device=dev)[None] < enc_lens[:, None]

    def frames_check(name, got):
        got = got[:, :f_off.shape[1]]
        diff = (got - f_off).abs()[valid]
        bar = 2e-4 + 1e-3 * f_off.abs()[valid]
        checks[name] = {"max_abs_err": diff.max().item(),
                        "max_over_bar": (diff / bar).max().item(),
                        "ok": bool((diff <= bar).all())}

    # (a) cache-aware, (b) windowed with its flash launches counted
    reset_all_launches()
    frames_check("cache_aware", S.stream_full_utterance_cached(S.CacheAwareStreamer(model, CH),
                                                               mel))
    launches = count("cache_aware")
    if any(launches.values()):
        raise AssertionError(f"streaming: the cache-aware step launched {launches}")
    reset_all_launches()
    se = S.StreamingEncoder(model, S.StreamingConfig(chunk_mel=CH, window_mel=1024))
    frames_check("windowed", S.stream_full_utterance(se, mel))
    launches = count("windowed")
    checks["windowed"]["flash_launches_per_window"] = launches["flash_relpos_mhsa"] / (n_chunks + 1)
    if launches != {**{k: 0 for k in launches}, "flash_relpos_mhsa": L * (n_chunks + 1)}:
        raise AssertionError(f"streaming: windowed launches {launches}, want {L} a window")

    # (c) StreamingASR, valid_mel on the rows' last chunks
    asr = S.StreamingASR(model, chunk_mel=CH)
    reset_all_launches()
    state = asr.init(B)
    for c0 in range(0, T_mel, CH):
        (ids, lens), state = asr.step(state, mel[:, :, c0:c0 + CH], lang,
                                      valid_mel=(mel_lens - c0).clamp(0, CH))
    count("streaming_asr")
    same = [bool(torch.equal(ids[b, :lens[b]], want_ids[b, :want_lens[b]])) for b in range(B)]
    checks["streaming_asr"] = {"rows_equal": sum(same), "rows": B,
                               "tokens": int(want_lens.sum()),
                               "ok": all(same) and torch.equal(lens, want_lens)}

    # (d) stream_demo against transcribe on two WAVs of the run dir
    wavs = [e.audio_filepath for e in long[:2]]
    reset_all_launches()
    t0 = time.perf_counter()
    hyps, _ = quiet_main(transcribe.main, ["--run", run, "--task", "0:hindi", "--lang", "hindi",
                                           *wavs, "--device", dev.type])
    torch.cuda.synchronize()
    wall["transcribe_s"] = time.perf_counter() - t0
    launches = count("transcribe")
    texts = []
    reset_all_launches()
    for wav in wavs:
        t0 = time.perf_counter()
        _, lines = quiet_main(stream_demo.main, [wav, "--run", run, "--task", "0:hindi",
                                                 "--device", dev.type])
        torch.cuda.synchronize()
        wall.setdefault("stream_demo_s", []).append(time.perf_counter() - t0)
        texts.append(json.loads(lines[-1])["text"])
    demo_launches = count("stream_demo")
    checks["stream_demo"] = {"texts": texts, "transcribe": hyps, "ok": texts == hyps,
                             "incremental_lines": len(lines) - 1}
    if (launches["flash_relpos_mhsa"] != L or launches["rnnt_greedy_decode_fused"] != 1
            or any(demo_launches.values())):
        raise AssertionError(f"streaming: transcribe launches {launches}, stream_demo "
                             f"{demo_launches}")
    log(f"  streaming checks (f32, B{B}, {n_chunks} chunks of {CH} mel): {checks}")
    bad = [k for k in ("cache_aware", "windowed", "streaming_asr", "stream_demo")
           if not checks[k]["ok"]]
    if bad:
        raise AssertionError(f"streaming: {bad} failed: {checks}")

    # step times a chunk (host clock around synchronised passes)
    def pass_ms(step, init, rows):
        state = init(rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c0 in range(0, T_mel, CH):
            _, state = step(state, mel[:rows, :, c0:c0 + CH])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_chunks

    def windowed_step(se):
        def step(state, chunk):
            *_, state = se.step(state, chunk)
            return None, state
        return step

    times = {}
    bf16 = HybridRNNTCTC(C.build_model_cfg(C.setup(argv + ["--mixed_precision", "true"])[0],
                                           tok, langs), device=dev)
    bf16.load_state_dict(model.state_dict())
    for dtype, m in (("f32", model), ("bf16", bf16)):
        ca = S.CacheAwareStreamer(m, CH)
        win = S.StreamingEncoder(m, S.StreamingConfig(chunk_mel=CH, window_mel=1024))
        for rows in (1, B):
            pass_ms(ca.step, ca.init, rows)  # warm-up
            ms = pass_ms(ca.step, ca.init, rows)
            times[f"cache_aware_{dtype}_B{rows}_ms"] = ms
            times[f"cache_aware_{dtype}_B{rows}_rtf"] = ms / (CH * frontend.hop_length
                                                              / frontend.sample_rate * 1e3)
        pass_ms(windowed_step(win), win.init, B)
        times[f"windowed_{dtype}_B{B}_ms"] = pass_ms(windowed_step(win), win.init, B)
    del bf16, model
    torch.cuda.empty_cache()
    wall["phase_s"] = time.perf_counter() - t_phase
    rec["streaming"] = {"checks": checks, "times_ms_per_chunk": times, "wall_s": wall,
                        "blank_biases": biases, "launches": total,
                        "shape": {"B": B, "T_mel": T_mel, "chunk_mel": CH, "left": A}}
    log(f"  streaming step ms a chunk ({nvidia_smi()}): {times}")
    print("streaming: " + json.dumps({"card": nvidia_smi(), "wall_s": wall,
                                       "times_ms_per_chunk": times, "launches": total}),
          flush=True)
    return total


def run_host_side(dev, rec, tasks, tok):
    """Phase 12 (the module's docstring says what it checks); the launch counts."""
    import torch

    from indic_cl_asr_torch.audio.features import FrontendConfig, output_seq_len
    from indic_cl_asr_torch.audio.io import load_audio
    from indic_cl_asr_torch.data.pipeline import BucketSpec, _assemble
    from indic_cl_asr_torch.models.conformer import subsampled_length
    from indic_cl_asr_torch.models.hybrid import flagship_config
    from indic_cl_asr_torch.ops import flash_mhsa as fm
    from indic_cl_asr_torch.ops import rnnt_loss as rl
    from indic_cl_asr_torch.scripts import bench_eval, flops_audit, profile_step
    from indic_cl_asr_torch.train.metrics import edit_distance_py, wer

    t_phase, out = time.perf_counter(), rec.setdefault("host_side", {})
    reset_all_launches()
    logdir = os.path.join(ROOT, "build", "chip_smoke", f"profile_step-{os.getpid()}")
    prof = quiet_main(profile_step.main, ["--steps", "3", "--top", "12", "--logdir", logdir,
                                          "--device", dev.type])[0]
    names = [r["hlo_op_name"] for r in profile_step._rows(logdir)]
    cats = {c["category"]: c["us"] for c in prof["by_category"]}
    out["profile_step"] = prof
    if not all(any(k in n for n in names) for k in ("flash_relpos_fwd", "flash_relpos_bwd",
                                                   "alpha_warp", "beta_warp")) or abs(
            sum(cats.values()) - prof["total_self_time_us"]) > 0.05 * len(cats):
        raise AssertionError(f"profile_step: kernels {names[:40]}, categories {cats}")
    audit = quiet_main(flops_audit.main, ["--device", dev.type])[0]
    mel = int(output_seq_len(torch.tensor(128000), FrontendConfig()))  # 8 s; T pads it to 16
    T, valid = (int(subsampled_length(torch.tensor(n), flagship_config().encoder))
                for n in (-(-mel // 16) * 16, mel))
    lens = torch.full((16,), valid)
    per = {"flash_relpos_mhsa": (fm.work(16, T, 512, lens)[1], 17),
           "flash_relpos_mhsa_backward": (fm.work_backward(16, T, 512, lens, 8)[1], 5),
           "rnnt_alpha": (rl.work(16, T, 49)[1], 1), "rnnt_beta": (rl.work(16, T, 49, True)[1], 1)}
    for prog, p in audit["programs"].items():
        for name, (flops, n) in per.items():
            k, n = p["kernels"].get(name, {"calls": 0, "flops": 0}), n * (
                prog != "loss_fwd" or name in ("flash_relpos_mhsa", "rnnt_alpha"))
            if not k["calls"] == p["launches"][name] == n or k["flops"] != n * flops:
                raise AssertionError(f"flops_audit {prog} {name}: {k}, {p['launches']}")
    out["flops_audit"], tflops = audit, {k: v for k, v in audit.items() if k.endswith("tflops")}
    log(f"  profile_step: {prof['total_self_time_us'] / 1e3:.2f} ms device of {prof['wall_ms']:.2f}"
        f" ms, idle {prof['idle_share']:.3f}, {cats}; flops_audit {tflops}")
    decoders = ["labelsync", "fused", "beam", "beam_fused"]
    bench = quiet_main(bench_eval.main, ["--decoders", ",".join(decoders), "--iters", "5",
                                         "--device", dev.type])[0]
    if [b["decoder"] for b in bench] != decoders or not all(b["value"] > 0 for b in bench):
        raise AssertionError(f"bench_eval: {bench}")
    out["bench_eval"], launches = bench, all_launches()
    # phase 8's WAVs: the native batch decode against the Python reader, in turns
    spec, ms = BucketSpec(), {"native": [], "python": []}
    for entries in (tasks[lang].train[i:i + 16] for lang in CL_LANGS for i in (0, 16)):
        for how, loader in (("native", load_audio), ("python", lambda p: load_audio(p))) * 3:
            t0 = time.perf_counter()
            b = _assemble(entries, 16, 1, spec, tok, {l: 0 for l in CL_LANGS}, 0, loader, None)
            ms[how].append((time.perf_counter() - t0) * 1e3)
            got = (b.audio.tobytes(), b.audio_len.tobytes())
            want = got if how == "native" else want
            if got != want:
                raise AssertionError("the native batch differs from the Python reader's")
    out["assemble_ms_b16"] = ms
    wers = {k: (wer(refs, hyps), sum(edit_distance_py(h.split(), r.split())
                                     for r, h in zip(refs, hyps)) / sum(len(r.split()) for r in refs))
            for k, (refs, hyps) in rec.pop("cli_texts").items()}
    if not all(a == b for a, b in wers.values()):
        raise AssertionError(f"native WER against the Python WER: {wers}")
    out["wer_native_python"], out["phase_s"] = wers, time.perf_counter() - t_phase
    log(f"  bench_eval {bench}; B16 assembly ms native {ms['native']}, python {ms['python']}; "
        f"WER native and Python {wers}; {out['phase_s']:.1f} s")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from indic_cl_asr_torch.ops import _build

    # phases 7-8 run the pallas joint with scripts/config.yaml's
    # rnnt_remat="none", which it ignores; rnnt_loss_fused warns so on
    # every such call
    warnings.filterwarnings("ignore", message="rnnt_remat='none' has no effect")

    dev = torch.device("cuda", 0)
    # f32 comparisons in full f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs of the plain versions accumulate in f32 like the kernels
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = nvidia_smi()
    rec = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    print(card, flush=True)
    log(f"[1/12] device: {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build()
    rec["build_s"] = time.perf_counter() - t0
    log(f"[2/12] build: {rec['build_s']:.1f} s {secs}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    rec["flash_forward_build"] = {
        "ptxas": ptxas_lines("flash_mhsa", "flash_relpos_fwd_mma_kernel", by_dim=True),
        "dynamic_shared_bytes": {f"D{d}": flash_mma_shared_bytes(d) for d in (16, 32, 64, 128)}}
    log(f"  flash forward (bf16 on mma.sync, 128 threads a block): ptxas "
        f"{rec['flash_forward_build']['ptxas']}; dynamic shared memory a block "
        f"{rec['flash_forward_build']['dynamic_shared_bytes']}")
    rec["flash_backward_build"] = {
        "ptxas": ptxas_lines("flash_mhsa", "flash_relpos_bwd_mma_kernel", by_dim=True),
        "dynamic_shared_bytes": {f"D{d}": flash_bwd_mma_shared_bytes(d) for d in (16, 32, 64)},
        "scalar_ptxas": ptxas_lines("flash_mhsa", "flash_relpos_bwd_kernel", by_dim=True)}
    log(f"  flash backward (bf16 on mma.sync, 128 threads a block): ptxas "
        f"{rec['flash_backward_build']['ptxas']}; dynamic shared memory a block "
        f"{rec['flash_backward_build']['dynamic_shared_bytes']}; the scalar kernel (f32, "
        f"and bf16 at D128): ptxas {rec['flash_backward_build']['scalar_ptxas']}")

    log("[3/12] kernels vs plain versions on the card")
    check_flash(dev, rec)
    check_decode(dev, rec)
    check_beam(dev, rec)
    check_flash_backward(dev, rec)
    check_lattice(dev, rec)
    check_head_dim_route(dev, rec)
    check_joint(dev, rec)

    log("[4/12] serving slice (flagship width, seeded random weights)")
    inputs, launches, decode_work, data = run_slice(dev, rec)

    log("[5/12] timing at the serving path's shapes")
    kernels = time_kernels(inputs, launches, decode_work, rec)
    del inputs
    torch.cuda.empty_cache()

    log("[6/12] training slice (flagship width, bf16, layers 0-11 frozen)")
    train_launches, captured, host_batch = run_training(dev, rec, *data)
    kernels += time_training_kernels(captured, train_launches, rec)
    del captured
    torch.cuda.empty_cache()

    log("[7/12] f32 step equality, card kernels vs CPU plain versions")
    for impl in ("xla", "pallas"):
        check_step_f32(dev, rec, host_batch, rnnt_impl=impl)

    log("[8/12] CL sequence (flagship width, rnnt_impl='pallas'; naive, EWC, MAS, LwF)")
    tasks, tok = make_cl_data(os.path.join(ROOT, "build", "chip_smoke", "cl", "wavs"))
    kernels += run_cl(dev, rec, tasks, tok)

    log("[9/12] the command line (config.yaml's flagship, --n_langs 2): cl_baseline, "
        "transcribe, results")
    rec["cli_launches"] = run_cli(dev, rec, tasks, tok)

    log("[10/12] the pretrained path: a .nemo of phase 4's flagship in f32, "
        "restore_pretrained, transcribe --nemo, eval_pretrained")
    rec["pretrained_launches"], f32 = run_pretrained(dev, rec, *data)

    log("[11/12] the streaming path (flagship width and depth, causal conv, "
        "att_context (70, 0), f32): cache-aware, windowed, StreamingASR, stream_demo")
    rec["streaming_launches"] = run_streaming(dev, rec, data[0])

    log("[12/12] the host side: profile_step, flops_audit, bench_eval, the native loader and WER")
    rec["host_launches"] = run_host_side(dev, rec, tasks, tok)
    order = ["flash_relpos_mhsa", "flash_relpos_mhsa_backward", "rnnt_alpha",
             "rnnt_beta", "joint_fused_forward", "joint_fused_backward",
             "rnnt_greedy_decode_fused", "rnnt_beam_search_fused"]
    kernels.sort(key=lambda k: order.index(k["name"]))
    # each kernel's launches over the main path's counted runs: the serving
    # slice (phase 4; the beam's from its own path), the training steps
    # (phase 6), the CL sequence (phase 8), the command line (phase 9), the
    # pretrained path (phase 10), the streaming path (phase 11) and the host
    # side (12); the model axis's split steps (phase 9, rank 0)
    phases = {"serving": launches, "training": train_launches, "cl": rec["cl_launches"],
              "cli": rec["cli_launches"], "model_axis": rec["model_axis_launches"],
              "pretrained": rec["pretrained_launches"],
              "streaming": rec["streaming_launches"], "host": rec["host_launches"]}
    rec["main_path_launches"] = {}
    for line in kernels:
        by = {ph: c.get(line["name"], 0) for ph, c in phases.items()}
        line["launches"] = sum(by.values())
        rec["main_path_launches"][line["name"]] = by
        if line["launches"] == 0:
            raise AssertionError(f"{line['name']} was not launched on the main path")
        if line["name"] in f32:  # phase 10's f32 time beside the bf16 one
            line["f32_ms"] = f32[line["name"]]["ms"]
    log(f"  launches on the main path by phase: {rec['main_path_launches']}")
    rec["kernels"] = kernels
    # the end-to-end numbers the fused joint moves: a flagship CL step
    # under each rnnt_impl (wall and device-busy ms, idle share, peak
    # memory) and the CL sequences, whose steps run the pallas joint
    prof = rec["cl_step_profile"]
    rec["end_to_end"] = {
        "cl_step_ms": rec["cl_step_ms"],
        "cl_step_busy_ms": {impl: prof[impl]["device_busy_ms"] for impl in prof},
        "cl_step_idle_share": {impl: prof[impl]["idle_share"] for impl in prof},
        "cl_step_peak_bytes": {impl: m["peak"] for impl, m in rec["cl_step_memory_bytes"].items()},
        "cl_wall_s": {m: rec["cl"][m]["wall_s"] for m in CL_METHODS}}
    e2e = rec["end_to_end"]
    log(f"end to end: CL step ms (two turns each) {e2e['cl_step_ms']}, device-busy ms "
        f"{e2e['cl_step_busy_ms']}, idle share {e2e['cl_step_idle_share']}, peak bytes "
        f"{e2e['cl_step_peak_bytes']}; CL sequence wall s {e2e['cl_wall_s']}")
    rec["total_s"] = time.perf_counter() - t_start
    log(f"total {rec['total_s']:.1f} s")
    print("record " + json.dumps(rec))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
