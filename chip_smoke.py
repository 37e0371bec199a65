#!/usr/bin/env python3
"""Drive the PyTorch port (indic_cl_asr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script when it fails:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Build: compiles the three CUDA sources in indic_cl_asr_torch/csrc
   (flash_mhsa.cu: flash forward and backward; decode_fused.cu;
   rnnt_lattice.cu: alpha and beta) with nvcc for sm_90a, one nvcc per
   source, started together.
3. Kernels against their plain PyTorch versions on the card:
   flash rel-pos attention at B16 T204 E512 H8 in f32 (max abs err
   <= 1e-4) and bf16 (<= 2e-2), plus T in {1, 37, 512}, a row with
   lens=0 and a (16, 0) band; the fused greedy decode at flagship widths
   (B16, T 204 and 300 in one language, and T 204 with the rows spread
   over the 12 languages; four draws each), token-exact in f32, and in
   bf16 at least 90% of the plain version's tokens reproduced before
   their row's first divergence (see check_decode for why tokens).
   The flash backward against autograd through the plain version on the
   same cases, with dropout 0 and 0.1 (the same bits on both sides): max
   error per gradient <= 1e-4·max|ref| in f32 and 2e-2·max|ref| in bf16;
   the kernels' dropout bits equal to the plain version's, keep rate
   within 5e-3 of 1 - rate; the alpha and beta lattices at B16 T204
   U+1 129 (rows with u_len 0, t_len 1, t_len < T): finite entries atol
   1e-4, the NLL and both slab gradients rel 1e-5.
4. The serving slice: 32 synthetic 16 kHz WAVs in two duration buckets,
   a char tokenizer trained here, the flagship model (17 layers, d512,
   bf16, flash attention) with seeded random weights, transcribed with the
   RNNT and CTC decoders through ``Transcriber``. The launch counts are
   reset just before and read just after this run: flash launches must be
   17 x the encoder batches and decode launches the RNNT batches. Then the
   same model in f32, once through the kernels and once through the plain
   paths (eager attention, frame-sync decode): identical hypotheses.
5. Timing at the serving path's shapes (CUDA events): each kernel, its
   plain version, and its bound (bytes over 3.35 TB/s or operations over
   the 989 TFLOP/s bf16 peak, whichever is larger).
6. The training slice: the flagship model (bf16, flash attention, layers
   0-11 frozen, the flagship dropouts, SpecAugment on) trained with
   ``make_train_step`` and AdamW (lr 1e-4, wd 0.01) on ``BatchPipeline``
   batches of 16 from the 4-8 s bucket (T 204, U 128), StepConfig as
   scripts/config.yaml sets it. The counts are reset just before the
   timed steps and read just after: per step 17 flash forwards, 5 flash
   backwards, 1 alpha and 1 beta. Every loss finite, the frozen parameters
   bit-unchanged, and a falling loss over 30 steps on one batch. Prints
   ms/step, utts/s, peak memory and one profiled step; then times the
   three training kernels at the inputs the step gave them.
7. f32 equality of one step: flagship width at 4 layers (2 frozen), B4,
   attention dropout 0.1 (the kernel's bits), SpecAugment on (bands from
   the CPU generator), the other dropouts and dither off: the step on the
   card through the kernels against the same step on the CPU through the
   plain versions. Losses rel 1e-4, each gradient within 1e-3·max|grad|,
   BatchNorm statistics atol 1e-5, updated parameters atol 2·lr + 1e-6.

Prints the card's name and power limit (``nvidia-smi``) on a line of its
own first, then the full record as one ``record {...}`` line, the
``{"kernels": [...]}`` line, and as its last line ``{"ok": true,
"device": {...}}``. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
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


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def check_flash(dev, rec):
    import torch

    from indic_cl_asr_torch.ops.flash_mhsa import (
        flash_relpos_mhsa,
        flash_relpos_mhsa_reference,
    )

    full = [204] * 6 + [203, 190, 180, 160, 150, 120, 100, 64, 1, 0]
    cases = [
        ("B16 T204 E512 H8", 16, 204, full, (-1, -1)),
        ("T1", 2, 1, [1, 0], (-1, -1)),
        ("T37", 3, 37, [37, 20, 0], (-1, -1)),
        ("T512", 2, 512, [512, 300], (-1, -1)),
        ("band(16,0)", 4, 204, [204, 150, 17, 0], (16, 0)),
    ]
    errs = {}
    for name, B, T, lens, (left, right) in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = flash_inputs(B, T, 8, 64, lens, dtype, dev, seed=T + B)
            out = flash_relpos_mhsa(*args, n_heads=8, left=left, right=right)
            ref = flash_relpos_mhsa_reference(*args, n_heads=8, left=left, right=right)
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

    blank = model.cfg.blank_local
    B, T, _ = f_proj.shape
    with torch.inference_mode():
        g, _ = model.pred_step(torch.full((B,), blank, device=f_proj.device), None)
        x = torch.relu(f_proj + g[:, None]).float()
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


def make_data(root, n=32, seed=0):
    """32 WAVs of one language in two buckets (2.5-4 s and 4.5-8 s)."""
    import numpy as np

    from indic_cl_asr_torch.audio.io import write_wav
    from indic_cl_asr_torch.data.manifest import ManifestEntry

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    words = ["namaste", "dhanyavad", "pani", "ghar", "samay", "kal", "aaj"]
    entries = []
    for i in range(n):
        dur = float(rng.uniform(2.5, 4.0) if i % 2 == 0 else rng.uniform(4.5, 8.0))
        samples = int(dur * 16000)
        t = np.arange(samples) / 16000.0
        f0 = rng.uniform(100, 300)
        wav = 0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
        wav = (wav + 0.05 * rng.standard_normal(samples)).astype(np.float32)
        path = os.path.join(root, f"utt_{i:02d}.wav")
        write_wav(path, wav, 16000)
        text = " ".join(rng.choice(words, size=int(rng.integers(2, 6))))
        entries.append(ManifestEntry(audio_filepath=path, duration=dur, text=text, lang="hindi"))
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
    rec["profile_rnnt"] = profile_pass(tr, entries, (t1 - t0) * 1e3)
    enc_inputs = capture_main_path_inputs(model, tr.frontend, long_batch)

    # --- f32: through the kernels, and through the plain paths ---
    f32 = {}
    for name, attn, greedy in (("kernels", "flash", "fused"), ("plain", "xla", "framesync")):
        m = HybridRNNTCTC(flagship_config(torch.float32, attn_impl=attn), device=dev)
        serving_weights_(m, seed=0, blank_bias=biases)
        t = transcriber(m, greedy_impl=greedy)
        f32[name] = {d: t.transcribe(entries, d) for d in ("rnnt", "ctc")}
        del m, t
        torch.cuda.empty_cache()
    for d in ("rnnt", "ctc"):
        a, b = f32["kernels"][d], f32["plain"][d]
        bad = [i for i in range(len(a)) if a[i] != b[i]]
        log(f"  f32 {d}: {len(a) - len(bad)}/{len(a)} hypotheses identical "
            "(kernels vs plain)")
        if bad:
            i = bad[0]
            raise AssertionError(f"f32 {d} utt {i}: {a[i]!r} != {b[i]!r}")
    rec["slice_f32_identical"] = True
    return enc_inputs, launches, decode_work, (entries, tok, langs)


def profile_pass(tr, entries, wall_ms, top=12):
    """torch.profiler over one RNNT pass of the slice (after the counted
    run): device-busy time (the sum of the kernels' and copies' device
    times on the one stream, against ``wall_ms``, the same pass timed
    without the profiler) and the kernels that take the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.transcribe(entries, "rnnt")
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    rows = [{"name": e.key[:90], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in events[:top]]
    log(f"  profile (one rnnt pass, {len(entries)} utts): device busy "
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
        ms = cuda_ms(lambda: fm.flash_relpos_mhsa(q, k, v, p, u, vb, lens, **kw))
        plain = cuda_ms(lambda: fm.flash_relpos_mhsa_reference(q, k, v, p, u, vb, lens, **kw))
    nbytes, flops = fm.work(B, T, E, lens.cpu(), itemsize=2)
    b_ms, b_by = bound_ms(nbytes, flops)
    lines.append({
        "name": "flash_relpos_mhsa", "route": "cuda",
        "source": "indic_cl_asr_torch/csrc/flash_mhsa.cu",
        "replaces": "indic_cl_asr_tpu/ops/flash_mhsa.py:383",
        "launches": launches["flash_relpos_mhsa"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })
    log(f"  flash B{B} T{T} E{E} bf16: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {nbytes} B, {flops} flop), err {err:.3e}")

    f_proj, enc_lens = model_inputs["f_proj"], model_inputs["enc_lens"]
    dargs = (f_proj, enc_lens, model_inputs["lang"], model_inputs["model"])
    with torch.inference_mode():
        ids, n = dfm.rnnt_greedy_decode_fused(*dargs)
        ids_p, n_p = dfm.rnnt_greedy_decode_fused_reference(*dargs)
        rows = int(((ids == ids_p).all(dim=1) & (n == n_p)).sum())
        dfm.reset_counts()
        ms = cuda_ms(lambda: dfm.rnnt_greedy_decode_fused(*dargs), iters=5, warmup=0)
        work_each = {k_: v_ // 5 for k_, v_ in dfm.work_counts().items()}
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
    log(f"  decode B{B} T{T} bf16: {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {nbytes} B, {flops} flop), work {work_each}, "
        f"tokens {n.tolist()}, bf16 rows identical to plain {rows}/{B}")
    rec["decode_bf16_main_rows_identical"] = rows
    rec["decode_work_per_launch"] = work_each
    rec["decode_work_main_path"] = decode_work_main
    return lines


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

    full = [204] * 6 + [203, 190, 180, 160, 150, 120, 100, 64, 1, 0]
    cases = [
        ("B16 T204 E512 H8", 16, 204, full, (-1, -1)),
        ("T1", 2, 1, [1, 0], (-1, -1)),
        ("T37", 3, 37, [37, 20, 0], (-1, -1)),
        ("T512", 2, 512, [512, 300], (-1, -1)),
        ("band(16,0)", 4, 204, [204, 150, 17, 0], (16, 0)),
    ]
    errs = {}
    for name, B, T, lens, (left, right) in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            for rate in (0.0, 0.1):
                args = flash_inputs(B, T, 8, 64, lens, dtype, dev, seed=T + B)
                kw = dict(n_heads=8, left=left, right=right, dropout_rate=rate, seed=T + 7)
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
    bits = flash_dropout_bits_kernel(987654321, 16, 8, 204, dev)
    want = dropout_bits(987654321, 16, 8, 204, dev)
    keep = (bits <= keep_threshold(0.1)).double().mean().item()
    log(f"  dropout bits B16 H8 T204: equal {torch.equal(bits, want)}, keep rate "
        f"{keep:.5f} at rate 0.1")
    if not torch.equal(bits, want) or abs(keep - 0.9) >= 5e-3:
        raise AssertionError("flash dropout bits differ from the plain version's")
    rec["dropout_bits"] = {"equal": True, "keep_rate": keep}


def lattice_inputs(dev, B=16, T=204, U1=129, seed=0):
    import torch

    g = torch.Generator().manual_seed(seed)
    lb = -torch.rand((B, T, U1), generator=g) * 3
    ll = -torch.rand((B, T, U1), generator=g) * 3
    t_lens = torch.tensor([T] * 12 + [1, 150, 100, T], dtype=torch.int32)
    u_lens = torch.tensor([U1 - 1, 0, 64, 1] * 4, dtype=torch.int32)
    return lb.to(dev), ll.to(dev), t_lens.to(dev), u_lens.to(dev)


def check_lattice(dev, rec):
    import torch

    from indic_cl_asr_torch.ops import rnnt_loss as R

    lb, ll, tl, ul = lattice_inputs(dev)
    lpb, lpl, _, _ = R._prepare(lb, ll, tl, ul)
    out = {}
    for name, got, want in (("alpha", R.rnnt_alpha(lpb, lpl), R._alpha_scan(lpb, lpl)),
                            ("beta", R.rnnt_beta(lpb, lpl, ul), R._beta_scan(lpb, lpl, ul))):
        fin = want > R.NEG_INF / 2
        if not torch.equal(fin, got > R.NEG_INF / 2):
            raise AssertionError(f"{name}: finite entries differ")
        err = (got[fin] - want[fin]).abs().max().item()
        out[name] = err
        log(f"  {name} B16 T204 U+1 129: max abs err {err:.3e} on finite entries (tol 1e-4)")
        if not (err <= 1e-4):
            raise AssertionError(f"{name}: {err} > 1e-4")
    x, y = lb.clone().requires_grad_(True), ll.clone().requires_grad_(True)
    nll = R.rnnt_nll_from_logprobs(x, y, tl, ul)
    gx, gy = torch.autograd.grad(nll.sum(), (x, y))
    xp, yp = lb.clone().requires_grad_(True), ll.clone().requires_grad_(True)
    nll_p = R.rnnt_nll_from_logprobs_reference(xp, yp, tl, ul)
    gxp, gyp = torch.autograd.grad(nll_p.sum(), (xp, yp))
    out["nll_rel"] = ((nll - nll_p).abs() / nll_p.abs()).max().item()
    out["grad_rel"] = max((a - b).abs().max().item() / b.abs().max().item()
                          for a, b in ((gx, gxp), (gy, gyp)))
    log(f"  rnnt nll rel err {out['nll_rel']:.3e}, slab grads rel err "
        f"{out['grad_rel']:.3e} (tol 1e-5)")
    if not (out["nll_rel"] <= 1e-5 and out["grad_rel"] <= 1e-5):
        raise AssertionError(f"rnnt loss through the lattice kernels: {out}")
    rec["lattice_errors"] = out


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


def training_counts():
    from indic_cl_asr_torch.ops import flash_mhsa as fm
    from indic_cl_asr_torch.ops import rnnt_loss as R

    return {"flash_relpos_mhsa": fm.flash_relpos_mhsa.launches,
            "flash_relpos_mhsa_backward": fm.flash_relpos_mhsa_backward.launches,
            "rnnt_alpha": R.rnnt_alpha.launches, "rnnt_beta": R.rnnt_beta.launches}


def reset_training_counts():
    from indic_cl_asr_torch.ops import flash_mhsa as fm
    from indic_cl_asr_torch.ops import rnnt_loss as R

    fm.flash_relpos_mhsa.launches = 0
    fm.flash_relpos_mhsa_backward.launches = 0
    R.rnnt_alpha.launches = 0
    R.rnnt_beta.launches = 0


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(batch, torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    rows = [{"name": e.key[:90], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in events[:top]]
    launches = sum(e.count for e in events)
    log(f"  profile (one training step): device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall unprofiled (idle share {1 - busy_ms / wall_ms:.3f}); "
        f"{launches} device kernels and copies")
    for r in rows:
        log(f"    {r['device_ms']:9.3f} ms  {r['calls']:6d}x  {r['name']}")
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    host.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    host_rows = [{"name": e.key[:60], "calls": e.count,
                  "host_ms": e.self_cpu_time_total / 1e3} for e in host[:top]]
    log("  host ops by self time (profiled, so inflated):")
    for r in host_rows:
        log(f"    {r['host_ms']:9.3f} ms  {r['calls']:6d}x  {r['name']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "device_ops": launches, "top": rows,
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
            "rnnt_alpha": n, "rnnt_beta": n}
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


def grad_scale(name, grads):
    """max|grad| of parameter ``name``, or of its weight where its own
    gradient is only rounding residue (ZERO_GRADIENT)."""
    for bias, weight in ZERO_GRADIENT.items():
        if name.endswith(bias):
            name = name[: -len(bias)] + weight
    return max(grads[name].abs().max().item(), 1e-30)


def check_step_f32(dev, rec, host_batch, lr=1e-4):
    """One f32 step at flagship width, 4 layers (2 frozen), B4, on the card
    through the kernels and on the CPU through the plain versions."""
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
                          rnnt_remat="none", uniform_lang_head=True)
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
    want = {"flash_relpos_mhsa": 4, "flash_relpos_mhsa_backward": 2, "rnnt_alpha": 1,
            "rnnt_beta": 1}
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
    log(f"  f32 step, card vs CPU: loss rel err {loss_rel:.3e} (tol 1e-4), grad err / "
        f"max|grad| {grad_rel:.3e} (1e-3), BatchNorm stats {bn_err:.3e} (1e-5), params "
        f"{par_err:.3e} ({2 * lr + 1e-6:g}); card {t_c:.2f} s, CPU {t_p:.2f} s")
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3 and bn_err <= 1e-5
            and par_err <= 2 * lr + 1e-6):
        raise AssertionError(f"f32 step card vs CPU: {res}")
    rec["step_f32_card_vs_cpu"] = res


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
    ms = cuda_ms(lambda: fm.flash_relpos_mhsa_backward(*args, **kw))
    plain = cuda_ms(lambda: fm.flash_relpos_mhsa_backward_reference(
        q, k, v, p, u, vb, lens, dout, **kw), iters=5)
    nbytes, flops = fm.work_backward(B, T, E, lens.cpu(), itemsize=q.element_size())
    b_ms, b_by = bound_ms(nbytes, flops)
    lines.append({
        "name": "flash_relpos_mhsa_backward", "route": "cuda",
        "source": "indic_cl_asr_torch/csrc/flash_mhsa.cu",
        "replaces": "indic_cl_asr_tpu/ops/flash_mhsa.py:416",
        "launches": launches["flash_relpos_mhsa_backward"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })
    log(f"  flash backward B{B} T{T} E{E} bf16 (dropout {kw['dropout_rate']}): {ms:.4f} ms, "
        f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes} B, {flops} flop), "
        f"err {err:.3e}")
    # the forward at the same operands with the step's dropout, for PERF's row 1
    with torch.no_grad():
        fwd_kw = dict(kw)
        fwd_ms = cuda_ms(lambda: fm.flash_relpos_mhsa(q, k, v, p, u, vb, lens, **fwd_kw))
        fwd_kw["dropout_rate"] = 0.0
        fwd_ms0 = cuda_ms(lambda: fm.flash_relpos_mhsa(q, k, v, p, u, vb, lens, **fwd_kw))
    rec["flash_forward_training_shapes"] = {"dropout_ms": fwd_ms, "no_dropout_ms": fwd_ms0,
                                            "dropout_rate": kw["dropout_rate"]}
    log(f"  flash forward at the same operands: {fwd_ms:.4f} ms with dropout "
        f"{kw['dropout_rate']}, {fwd_ms0:.4f} ms without")

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
            "library_ms": None,
        })
        log(f"  {name} B{B} T{T} U+1 {U1}: {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}; {nbytes} B, {flops} flop), err {err:.3e}")
    return lines


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from indic_cl_asr_torch.ops import _build

    dev = torch.device("cuda", 0)
    # f32 comparisons in full f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs of the plain versions accumulate in f32 like the kernels
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = nvidia_smi()
    rec = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    print(card, flush=True)
    log(f"[1/7] device: {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build()
    rec["build_s"] = time.perf_counter() - t0
    log(f"[2/7] build: {rec['build_s']:.1f} s {secs}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[3/7] kernels vs plain versions on the card")
    check_flash(dev, rec)
    check_decode(dev, rec)
    check_flash_backward(dev, rec)
    check_lattice(dev, rec)

    log("[4/7] serving slice (flagship width, seeded random weights)")
    inputs, launches, decode_work, data = run_slice(dev, rec)

    log("[5/7] timing at the serving path's shapes")
    kernels = time_kernels(inputs, launches, decode_work, rec)
    del inputs
    torch.cuda.empty_cache()

    log("[6/7] training slice (flagship width, bf16, layers 0-11 frozen)")
    train_launches, captured, host_batch = run_training(dev, rec, *data)
    kernels += time_training_kernels(captured, train_launches, rec)
    del captured
    torch.cuda.empty_cache()

    log("[7/7] f32 step equality, card kernels vs CPU plain versions")
    check_step_f32(dev, rec, host_batch)
    order = ["flash_relpos_mhsa", "flash_relpos_mhsa_backward", "rnnt_alpha",
             "rnnt_beta", "rnnt_greedy_decode_fused"]
    kernels.sort(key=lambda k: order.index(k["name"]))
    rec["kernels"] = kernels
    rec["total_s"] = time.perf_counter() - t_start
    log(f"total {rec['total_s']:.1f} s")
    print("record " + json.dumps(rec))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
