"""Where the fused greedy RNNT decode's time goes, from CUDA events alone.

    python -m indic_cl_asr_torch.tools.profile_decode [--clusters 4,8,16] [--out FILE.json]
    python -m indic_cl_asr_torch.tools.profile_decode --beam [--parent ROOT] [--out FILE.json]

At flagship widths (pred and joint 640, 12 languages x 256 tokens +
blank, bf16) with seeded random weights (heads scaled by 8, as
``chip_smoke.py``'s serving weights) and a seeded random f_proj of B16
T204 with lengths T/2..T, for three blank biases (1%, 3% and 10% of the
frames opening an emission), it measures:

- the B16 launch (CUDA events) and its work counters;
- each row alone, as a B1 launch, with its own counters;
- a least-squares fit over the single-row launches of
  ``ms = a + b * joint evaluations + c * LSTM steps``: b and c are the
  costs of one round and of one step of a row's chain, and the bytes one
  step reads (W_ih, W_hh and W_p) over c are the rate at which one row
  draws its weights from L2;
- the B16 launch against its slowest row alone: how much the rows of a
  batch slow each other down when they run together;
- with ``--clusters``, all of it again for each cluster size (blocks a
  row; 8 is the kernel's): how the per-step and per-joint costs fall
  with the SMs a row draws its weights through, which separates the part
  the L2 draw sets from the part the barriers set.

Beam mode, ``--beam [--parent ROOT]``: the fused beam
(``ops/beam_fused.py``) of this checkout and of the checkout under ROOT
(the parent, unpacked with ``git archive``), each in processes of its own
that import that checkout's package, in turns (parent, this, this,
parent), on the same seeded inputs: B16 T204 in one language, K4 P4,
max_expansions 10, max_out 256, bf16, the blank bias at the quantiles
above. For each it gives the B16 launch (CUDA events, device ms) and its
work counters, ms per round of the launch's longest row, each row alone
as a B1 launch with its counters, the single-row fit ``ms = a + b *
joint evaluations + c * LSTM steps`` with µs per round of the rows, and
the work counters of one f32 launch on the same inputs (equal in both
checkouts when both take the plain version's decisions).

Prints one line per measurement and the whole record as JSON (also to
``--out``). Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _port():
    """(models.hybrid, ops._build, ops.decode_fused, ops.beam_fused) of the
    package sys.path finds first: the beam mode's processes put the
    checkout under test there before this import."""
    from indic_cl_asr_torch.models import hybrid
    from indic_cl_asr_torch.ops import _build, beam_fused, decode_fused

    return hybrid, _build, decode_fused, beam_fused


def _ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _blank_bias(model, f_proj, lens, lang, q):
    """The blank bias at which a fraction 1-q of the valid frames prefer a
    token over blank at the start of decoding."""
    B, T, _ = f_proj.shape
    lang = lang.long()
    g0, _ = model.pred_step(torch.full((B,), model.cfg.blank_local, device=f_proj.device), None)
    x = torch.relu(f_proj + g0[:, None]).float()
    logits = torch.einsum("bth,bhv->btv", x, model.joint.head_kernel[lang].float())
    logits = logits + model.joint.head_bias[lang].float()[:, None]
    blank_logit = logits[..., -1] - model.joint.head_bias[lang, -1].float()[:, None]
    margin = logits[..., :-1].amax(-1) - blank_logit
    valid = torch.arange(T, device=f_proj.device)[None] < lens[:, None]
    return float(torch.quantile(margin[valid], q))


def _counted(fn):
    dfm = _port()[2]
    dfm.reset_counts()
    out = fn()
    return out, dfm.work_counts()


def profile(B=16, T=204, seed=1, qs=(0.99, 0.97, 0.9), iters=5, clusters=None):
    """The record above, for the kernel's cluster size or, with
    ``clusters``, for each size given (under "by_cluster")."""
    dfm = _port()[2]
    if not clusters:
        return _profile(B, T, seed, qs, iters)
    keep = dfm.CLUSTER
    try:
        out = {}
        for C in clusters:
            dfm.CLUSTER = C
            print(f" cluster of {C} blocks a row:", flush=True)
            try:
                out[str(C)] = _profile(B, T, seed, qs, iters)
            except RuntimeError as e:  # a size the card refuses: record it, go on
                print(f"  refused: {e}", flush=True)
                out[str(C)] = {"error": str(e)}
    finally:
        dfm.CLUSTER = keep
    return {"by_cluster": out}


def _profile(B, T, seed, qs, iters):
    hybrid, _, dfm, _ = _port()
    dev = torch.device("cuda")
    model = hybrid.HybridRNNTCTC(hybrid.flagship_config(torch.bfloat16, n_layers=1), device=dev)
    hybrid.init_weights_(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(T)
    f_proj = torch.randn((B, T, 640), generator=g).to(dev, torch.bfloat16)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g).to(dev)
    lang = torch.full((B,), 3, dtype=torch.int32, device=dev)
    cfg = model.cfg
    Hp, Hj = cfg.pred_hidden, cfg.joint_hidden
    step_bytes = (2 * Hp * 4 * Hp + Hp * Hj) * 2
    rec = {"batch": B, "frames": T, "step_bytes": step_bytes, "levels": []}
    xs, ys = [], []
    with torch.inference_mode():
        model.joint.head_kernel.mul_(8.0)
        for q in qs:
            model.joint.head_bias[:, -1] = _blank_bias(model, f_proj, lens, lang, q)
            args = (f_proj, lens, lang, model)
            (_, n), work = _counted(lambda: dfm.rnnt_greedy_decode_fused(*args))
            launch_ms = _ms(lambda: dfm.rnnt_greedy_decode_fused(*args), iters)
            rows = []
            for r in range(B):
                one = (f_proj[r:r + 1], lens[r:r + 1], lang[r:r + 1], model)
                _, w = _counted(lambda: dfm.rnnt_greedy_decode_fused(*one))
                ms = _ms(lambda: dfm.rnnt_greedy_decode_fused(*one), 3)
                rows.append({"frames": int(lens[r]), "tokens": int(n[r]),
                             "joint_evals": w["joint_evals"], "lstm_steps": w["lstm_steps"],
                             "ms": ms})
                xs.append([1.0, w["joint_evals"], w["lstm_steps"]])
                ys.append(ms)
            slow = max(range(B), key=lambda r: rows[r]["ms"])
            level = {"q": q, "launch_ms": launch_ms, "work": work, "rows": rows,
                     "slowest_row": slow, "slowest_row_ms": rows[slow]["ms"],
                     "launch_over_slowest_row": launch_ms / rows[slow]["ms"]}
            rec["levels"].append(level)
            print(f"  blank quantile {q}: B{B} launch {launch_ms:.4f} ms, work {work}; "
                  f"slowest row alone {rows[slow]['ms']:.4f} ms ({rows[slow]['joint_evals']} "
                  f"joints, {rows[slow]['lstm_steps']} steps); launch / slowest row "
                  f"{level['launch_over_slowest_row']:.3f}", flush=True)
    sol = torch.linalg.lstsq(torch.tensor(xs, dtype=torch.float64),
                             torch.tensor(ys, dtype=torch.float64)[:, None]).solution[:, 0]
    a, b, c = (float(v) for v in sol)
    resid = (torch.tensor(xs, dtype=torch.float64) @ sol - torch.tensor(ys, dtype=torch.float64))
    rec["fit"] = {"a_ms": a, "us_per_joint": b * 1e3, "us_per_lstm_step": c * 1e3,
                  "row_l2_draw_gb_per_s": step_bytes / (c * 1e-3) / 1e9 if c > 0 else None,
                  "max_abs_residual_ms": float(resid.abs().max()), "points": len(ys)}
    print(f"  single-row fit over {len(ys)} launches: {a:.4f} ms + {b * 1e3:.3f} us a joint "
          f"+ {c * 1e3:.3f} us an LSTM step (max residual "
          f"{rec['fit']['max_abs_residual_ms']:.4f} ms); one step reads {step_bytes} B, "
          f"so a row draws {rec['fit']['row_l2_draw_gb_per_s']} GB/s from L2", flush=True)
    return rec


def _beam_fit(xs, ys):
    sol = torch.linalg.lstsq(torch.tensor(xs, dtype=torch.float64),
                             torch.tensor(ys, dtype=torch.float64)[:, None]).solution[:, 0]
    resid = torch.tensor(xs, dtype=torch.float64) @ sol - torch.tensor(ys, dtype=torch.float64)
    return [float(v) for v in sol], float(resid.abs().max())


def beam_profile(B=16, T=204, seed=1, qs=(0.99, 0.97, 0.9), iters=5, dev="cuda"):
    """The beam mode's record for the checkout whose package this process
    imported (every name is looked up in it, so two checkouts run this
    same procedure)."""
    hybrid, _, _, bfm = _port()
    dev = torch.device(dev)
    kw = dict(beam_size=4, topk=4, max_expansions=10, max_out=256)
    models = {}
    for dtype in (torch.bfloat16, torch.float32):
        models[dtype] = hybrid.HybridRNNTCTC(hybrid.flagship_config(dtype, n_layers=1),
                                             device=dev)
        hybrid.init_weights_(models[dtype], torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(T)
    f32 = torch.randn((B, T, models[torch.float32].cfg.joint_hidden), generator=g).to(dev)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g).to(dev)
    lang = torch.full((B,), 3, dtype=torch.int32, device=dev)
    rec = {"batch": B, "frames": T, **kw, "levels": []}
    xs, ys = [], []
    with torch.inference_mode():
        for dtype, model in models.items():
            model.joint.head_kernel.mul_(8.0)
            f_proj = f32.to(dtype)
            for q in (qs if dtype == torch.bfloat16 else qs[1:2]):
                model.joint.head_bias[:, -1] = _blank_bias(model, f_proj, lens, lang, q)
                args = (f_proj, lens, lang, model)
                bfm.reset_counts()
                _, n, _ = bfm.rnnt_beam_search_fused(*args, **kw)
                work = bfm.work_counts()
                if dtype == torch.float32:
                    rec["f32_work"] = work
                    print(f"  f32 at blank quantile {q}: B{B} work {work}", flush=True)
                    continue
                launch_ms = _ms(lambda: bfm.rnnt_beam_search_fused(*args, **kw), iters)
                rows = []
                for r in range(B):
                    one = (f_proj[r:r + 1], lens[r:r + 1], lang[r:r + 1], model)
                    bfm.reset_counts()
                    bfm.rnnt_beam_search_fused(*one, **kw)
                    w = bfm.work_counts()
                    ms = _ms(lambda: bfm.rnnt_beam_search_fused(*one, **kw), 3)
                    rows.append({"frames": int(lens[r]), "tokens": int(n[r]), **w, "ms": ms,
                                 "us_per_round": 1e3 * ms / max(w["rounds"], 1)})
                    xs.append([1.0, w["joint_evals"], w["lstm_steps"]])
                    ys.append(ms)
                slow = max(range(B), key=lambda r: rows[r]["ms"])
                longest = max(range(B), key=lambda r: rows[r]["rounds"])
                level = {"q": q, "launch_ms": launch_ms, "work": work, "rows": rows,
                         "slowest_row": slow, "slowest_row_ms": rows[slow]["ms"],
                         "longest_row_rounds": rows[longest]["rounds"],
                         "launch_us_per_longest_row_round":
                             1e3 * launch_ms / max(rows[longest]["rounds"], 1),
                         "rows_us_per_round": sum(r_["us_per_round"] for r_ in rows) / B}
                rec["levels"].append(level)
                print(f"  bf16 at blank quantile {q}: B{B} launch {launch_ms:.4f} ms, work "
                      f"{work}; longest row {rows[longest]['rounds']} rounds "
                      f"({level['launch_us_per_longest_row_round']:.2f} us a round of it); "
                      f"rows alone {level['rows_us_per_round']:.2f} us a round on average, "
                      f"slowest {rows[slow]['ms']:.4f} ms", flush=True)
    (a, b, c), resid = _beam_fit(xs, ys)
    rec["fit"] = {"a_ms": a, "us_per_joint": b * 1e3, "us_per_lstm_step": c * 1e3,
                  "max_abs_residual_ms": resid, "points": len(ys)}
    print(f"  single-row fit over {len(ys)} launches: {a:.4f} ms + {b * 1e3:.3f} us a joint "
          f"evaluation + {c * 1e3:.3f} us an LSTM step (max residual {resid:.4f} ms)",
          flush=True)
    return rec


def _beam_child(root: str) -> int:
    """Run beam_profile on the package under ``root``; print its record."""
    sys.path.insert(0, root)
    build = _port()[1]
    build.build(["beam_fused"])
    ptxas = [line.strip() for line in build.BUILD_LOG.get("beam_fused", "").splitlines()
             if "registers" in line or "spill" in line]
    rec = {"root": root, "ptxas": ptxas, **beam_profile()}
    print("BEAM " + json.dumps(rec), flush=True)
    return 0


def beam_compare(parent: str) -> dict:
    """Parent, this checkout, this checkout, parent: each a process of its
    own running beam_profile on its package."""
    runs = []
    for root in (parent, HERE, HERE, parent):
        print(f" {'this checkout' if root == HERE else 'parent'} ({root}):", flush=True)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--beam-child", root],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if not line.startswith("BEAM "):
                print(line, flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"beam profile of {root} failed:\n{proc.stderr[-4000:]}")
        runs.append(json.loads(next(line[5:] for line in proc.stdout.splitlines()
                                    if line.startswith("BEAM "))))
    summary = []
    for r in runs:
        lv = {lvl["q"]: round(lvl["launch_ms"], 4) for lvl in r["levels"]}
        summary.append({"root": r["root"], "launch_ms": lv, "fit": r["fit"],
                        "f32_work": r["f32_work"]})
        print(f"  {r['root']}: B16 launch ms by blank quantile {lv}; fit {r['fit']}; f32 work "
              f"{r['f32_work']}", flush=True)
    equal = all(r["f32_work"] == runs[0]["f32_work"] for r in runs)
    print(f"  f32 work counters equal in every run: {equal}", flush=True)
    return {"runs": runs, "summary": summary, "f32_work_equal": equal}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="also write the record here")
    p.add_argument("--clusters", default=None,
                   help="comma-separated cluster sizes to measure (default: the kernel's)")
    p.add_argument("--beam", action="store_true",
                   help="time the fused beam of this checkout against --parent's")
    p.add_argument("--parent", default=os.path.join(HERE, "build", "parent"),
                   help="the other checkout of the beam mode (default: build/parent)")
    p.add_argument("--beam-child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device is available", file=sys.stderr)
        return 2
    if args.beam_child:
        return _beam_child(args.beam_child)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    if args.beam:
        rec = {"card": card, "torch": torch.__version__,
               **beam_compare(os.path.abspath(args.parent))}
        text = json.dumps(rec)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                f.write(text + "\n")
        print(text)
        return 0
    _build = _port()[1]
    _build.build(["decode_fused"])
    for line in _build.BUILD_LOG.get("decode_fused", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    clusters = [int(c) for c in args.clusters.split(",")] if args.clusters else None
    rec = {"card": card, "torch": torch.__version__, **profile(clusters=clusters)}
    text = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
