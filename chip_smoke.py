#!/usr/bin/env python3
"""Drive the PyTorch port (indic_cl_asr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script when it fails:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Build: compiles both CUDA kernels from indic_cl_asr_torch/csrc with
   nvcc for sm_90a (one nvcc per source, started together).
3. Kernels against their plain PyTorch versions on the card:
   flash rel-pos attention at B16 T204 E512 H8 in f32 (max abs err
   <= 1e-4) and bf16 (<= 2e-2), plus T in {1, 37, 512}, a row with
   lens=0 and a (16, 0) band; the fused greedy decode at flagship widths
   (B16, T 204 and 300 in one language, and T 204 with the rows spread
   over the 12 languages; four draws each), token-exact in f32, and in
   bf16 at least 90% of the plain version's tokens reproduced before
   their row's first divergence (see check_decode for why tokens).
4. The serving slice: 32 synthetic 16 kHz WAVs in two duration buckets,
   a char tokenizer trained here, the flagship model (17 layers, d512,
   bf16, flash attention) with seeded random weights, transcribed with the
   RNNT and CTC decoders through ``Transcriber``. The launch counts are
   reset just before and read just after this run: flash launches must be
   17 x the encoder batches and decode launches the RNNT batches. Then the
   same model in f32, once through the kernels and once through the plain
   paths (eager attention, frame-sync decode): identical hypotheses.
5. Timing at the main path's shapes (CUDA events): each kernel, its plain
   version, and its bound (bytes over 3.35 TB/s or operations over the
   989 TFLOP/s bf16 peak, whichever is larger).

Prints the card's name and power limit (``nvidia-smi``) on a line of its
own first, then the full record as one ``record {...}`` line, the
``{"kernels": [...]}`` line, and as its last line ``{"ok": true,
"device": {...}}``. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
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
    return enc_inputs, launches, decode_work


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
        x, pos_emb, lens, _ = args
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
    log(f"[1/5] device: {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build()
    rec["build_s"] = time.perf_counter() - t0
    log(f"[2/5] build: {rec['build_s']:.1f} s {secs}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[3/5] kernels vs plain versions on the card")
    check_flash(dev, rec)
    check_decode(dev, rec)

    log("[4/5] serving slice (flagship width, seeded random weights)")
    inputs, launches, decode_work = run_slice(dev, rec)

    log("[5/5] timing at the main path's shapes")
    kernels = time_kernels(inputs, launches, decode_work, rec)
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
