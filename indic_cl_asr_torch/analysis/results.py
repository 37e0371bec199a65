"""Offline results analysis: metrics -> WER/BWT tables and PDF plots
(own copy of indic_cl_asr_tpu/analysis/results.py).

Re-design of the reference's results pipeline (reference: results.py:
339-397 `calc_scores`, :433-934 `updated_plot_stats[_multi]`, :243-333
`plot_graph*`, :1003-1086 entry points), which consumes wandb CSV exports.
Ours reads the Logger's metrics.jsonl directly (one file per run; wandb CSV
is also accepted since the metric keys are identical:
``{val|test}/perf_{lang}_{rnnt|ctc}_{wer|noisy_wer|avg_wer}``).

Outputs per metric family:
  * per-run perf matrix [task, lang] (the matrix behind BWT),
  * WER-vs-task line plots per language, average/min/max WER bars across
    runs, box plots, BWT curves — saved as PDFs like the reference's
    results/ artifacts. The PDFs are drawn by analysis/pdf.py, so the
    report needs numpy alone.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict

import numpy as np

from ..train.driver import LANGUAGES
from ..train.metrics import bwt_scores
from .pdf import Figure, color

_PERF_RE = re.compile(
    r"^(val|test)/perf_(\w+?)_(rnnt|ctc)_(wer|noisy_wer|avg_wer)$"
)


def load_run_metrics(path: str) -> list[dict]:
    """Read a Logger metrics.jsonl (or log.txt — same records)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def load_wandb_csv(path: str) -> list[dict]:
    """Accept a wandb metric-table CSV export (reference results.py:121)."""
    import pandas as pd

    df = pd.read_csv(path)
    return df.to_dict("records")


def collect_perf(
    records: list[dict], split: str = "val", decoder: str = "rnnt",
    kind: str = "avg_wer", languages: list[str] | None = None,
) -> dict[str, list[float]]:
    """{lang: [wer at each recorded eval, in time order]}. The LAST record
    per (lang, task) wins (eval-at-end-of-task)."""
    languages = languages or LANGUAGES
    out: dict[str, list[float]] = defaultdict(list)
    per_task: dict[tuple[str, int], float] = {}
    for rec in records:
        task = rec.get("lang")
        # wandb CSV exports surface missing cells as float NaN, not None
        if not isinstance(task, (int, float)) or (
            isinstance(task, float) and not np.isfinite(task)
        ):
            continue
        for key, value in rec.items():
            m = _PERF_RE.match(str(key))
            if not m or value is None:
                continue
            if isinstance(value, float) and not np.isfinite(value):
                continue
            s, lang, dec, k = m.groups()
            if s == split and dec == decoder and k == kind:
                per_task[(lang, int(task))] = float(value)
    for (lang, task), wer in sorted(per_task.items(), key=lambda kv: kv[0][1]):
        out[lang].append(wer)
    return dict(out)


def perf_matrix(perf: dict[str, list[float]], languages: list[str]):
    """[n_tasks, n_langs] with NaN for unevaluated cells; record i of lang j
    is placed at row (j + i) — i.e. the task at which it was measured."""
    langs = [l for l in languages if l in perf]
    n = max((j + len(perf[l]) for j, l in enumerate(langs)), default=0)
    mat = np.full((n, len(langs)), np.nan)
    for j, lang in enumerate(langs):
        for i, w in enumerate(perf[lang]):
            if j + i < n:
                mat[j + i, j] = w
    return mat, langs


def summarize_run(records, languages=None, split="val"):
    """Per-decoder score summary (calc_scores analogue): avg/min/max WER per
    language + scalar BWT per task."""
    languages = languages or LANGUAGES
    out = {}
    for dec in ("rnnt", "ctc"):
        perf = collect_perf(records, split, dec, "avg_wer", languages)
        mat, langs = perf_matrix(perf, languages)
        summary = {}
        for j, lang in enumerate(langs):
            col = mat[:, j]
            col = col[~np.isnan(col)]
            if len(col):
                summary[lang] = {
                    "avg": float(col.mean()),
                    "min": float(col.min()),
                    "max": float(col.max()),
                    "final": float(col[-1]),
                    "first": float(col[0]),
                }
        sq = np.where(np.isnan(mat), 0.0, mat)
        out[dec] = {
            "per_lang": summary,
            "bwt": bwt_scores(sq).tolist() if mat.size else [],
            "matrix": mat.tolist(),
            "langs": langs,
        }
    return out


# ---------------------------------------------------------------------------
# plotting (PDF families like the reference's results/ dirs)
# ---------------------------------------------------------------------------

def plot_wer_vs_task(
    runs: dict[str, list[dict]], out_pdf: str, split="val", decoder="rnnt",
    languages=None,
):
    """One panel per language: WER after each task, one line per run
    (reference 'wer_vs_lang.pdf' family)."""
    languages = languages or LANGUAGES
    perfs = {
        name: collect_perf(recs, split, decoder, "avg_wer", languages)
        for name, recs in runs.items()
    }
    langs = [
        l for l in languages if any(l in p and p[l] for p in perfs.values())
    ]
    if not langs:
        return
    ncols = min(3, len(langs))
    nrows = -(-len(langs) // ncols)
    fig = Figure(nrows, ncols, size=(4 * ncols, 3 * nrows))
    for idx, lang in enumerate(langs):
        ax = fig.axes[idx // ncols][idx % ncols]
        for name, perf in perfs.items():
            ys = perf.get(lang, [])
            j = langs.index(lang)
            ax.plot([j + i + 1 for i in range(len(ys))], ys, label=name)
        ax.title, ax.xlabel, ax.ylabel = lang, "task", f"{decoder} WER"
        ax.legend()
    fig.save(out_pdf)


def plot_bwt(runs, out_pdf, split="val", decoder="rnnt", languages=None):
    languages = languages or LANGUAGES
    fig = Figure(1, 1, size=(6, 4))
    ax = fig.axes[0][0]
    for name, recs in runs.items():
        perf = collect_perf(recs, split, decoder, "avg_wer", languages)
        mat, langs = perf_matrix(perf, languages)
        if not mat.size:
            continue
        scores = bwt_scores(np.where(np.isnan(mat), 0.0, mat))
        ax.plot(range(1, len(scores) + 1), scores, marker="s", label=name)
    ax.xlabel, ax.ylabel = "task", f"BWT ({decoder} avg WER)"
    ax.axhline(0)
    ax.legend()
    fig.save(out_pdf)


def plot_box(runs, out_pdf, split="val", decoder="rnnt", languages=None):
    languages = languages or LANGUAGES
    data, names = [], []
    for name, recs in runs.items():
        perf = collect_perf(recs, split, decoder, "avg_wer", languages)
        vals = [w for ws in perf.values() for w in ws]
        if vals:
            data.append(vals)
            names.append(name)
    if not data:
        return
    fig = Figure(1, 1, size=(1.2 * len(data) + 2, 4))
    ax = fig.axes[0][0]
    ax.boxplot(data, positions=range(1, len(data) + 1),
               colors=[(1.0, 1.0, 1.0)] * len(data))
    ax.set_xticks(range(1, len(data) + 1), names)
    ax.ylabel = f"{decoder} WER (all langs/tasks)"
    fig.save(out_pdf)


# ---------------------------------------------------------------------------
# reference plot families: five PDFs per comparison dir
# (reference results.py:433-680 updated_plot_stats, :700-934
# updated_plot_stats_multi — line / shaded min-max / error-bar / BWT / box)
# ---------------------------------------------------------------------------

METRIC_KINDS = {"avg": "avg_wer", "": "wer", "noisy": "noisy_wer"}
METRIC_TITLES = {"avg": "Avg", "": "Normal", "noisy": "Noisy"}

_PDF_NAMES = (
    "wer_line_plot.pdf", "wer_shaded_plot.pdf", "wer_error_bars_plot.pdf",
    "bwt_plot.pdf", "wer_box_plot.pdf",
)


def calc_scores(
    runs: dict[str, list[dict]], decoder: str, metric: str = "avg",
    split: str = "val", languages=None,
):
    """(bwt, avg, min, max), each {run: {lang: float}} — the reference's
    calc_scores contract (results.py:339-397). ``metric`` is one of
    METRIC_KINDS ('' = clean/normal WER, 'noisy', 'avg' = their mean)."""
    kind = METRIC_KINDS[metric]
    languages = languages or LANGUAGES
    bwt, avg, mn, mx = {}, {}, {}, {}
    for name, recs in runs.items():
        perf = collect_perf(recs, split, decoder, kind, languages)
        mat, langs = perf_matrix(perf, languages)
        avg[name], mn[name], mx[name] = {}, {}, {}
        for j, lang in enumerate(langs):
            col = mat[:, j]
            col = col[~np.isnan(col)]
            if len(col):
                avg[name][lang] = float(col.mean())
                mn[name][lang] = float(col.min())
                mx[name][lang] = float(col.max())
        b = (
            bwt_scores(np.where(np.isnan(mat), 0.0, mat))
            if mat.size else np.zeros(0)
        )
        bwt[name] = {
            lang: float(b[j]) if j < len(b) else 0.0
            for j, lang in enumerate(langs)
        }
    return bwt, avg, mn, mx


def _score_langs(avg_scores, languages):
    seen = {l for per_lang in avg_scores.values() for l in per_lang}
    return [l for l in (languages or LANGUAGES) if l in seen]


def _grid(n):
    if n == 4:  # the reference's 2x2 special case for 4 panels
        fig = Figure(2, 2, size=(12, 10))
    else:
        fig = Figure(1, n, size=(max(6, 5 * n), 5))
    return fig, fig.flat()


def _draw_series(ax, kind, series, x, langs):
    """One panel: ``series`` is [(label, avg, lo, hi)] per line, values
    keyed by lang; ``kind`` picks the mark (line/shaded/errbar/bwt)."""
    for i, (label, av, lo, hi) in enumerate(series):
        y = np.array([av.get(l, np.nan) for l in langs])
        if kind == "line" or kind == "bwt":
            ax.plot(x, y, label=label)
        elif kind == "shaded":
            ax.plot(x, y, label=label)
            ax.fill_between(
                x,
                [lo.get(l, np.nan) for l in langs],
                [hi.get(l, np.nan) for l in langs],
                alpha=0.2,
            )
        elif kind == "errbar":
            lower = y - np.array([lo.get(l, np.nan) for l in langs])
            upper = np.array([hi.get(l, np.nan) for l in langs]) - y
            ax.errorbar(x + i * 0.1, y, lower, upper, label=label)
    ax.set_xticks(x, langs, angle=45.0)
    ax.xlabel = "Language"
    ax.grid = True
    ax.legend()


def _draw_box(ax, groups, langs):
    """Segment box plot: WER over the first n/3, 2n/3, n languages, one box
    per (segment, group) with per-group colors (results.py:594-668)."""
    n = len(langs)
    segments = [max(n // 3, 1), max(2 * n // 3, 1), n]
    data, positions, box_colors = [], [], []
    for seg_idx, seg in enumerate(segments):
        for g_idx, (label, av) in enumerate(groups):
            data.append([av[l] for l in langs[:seg] if l in av] or [np.nan])
            positions.append(seg_idx * (len(groups) + 1) + g_idx)
            box_colors.append(color(g_idx))
    ax.boxplot(data, positions, box_colors)
    centers = [
        i * (len(groups) + 1) + (len(groups) - 1) / 2
        for i in range(len(segments))
    ]
    ax.set_xticks(centers, [str(s) for s in segments])
    ax.xlabel = "Languages"
    ax.grid = True
    ax.legend([(groups[i][0], color(i), "s") for i in range(len(groups))])


def _render_family(
    out_dir: str, panels, langs, title_suffix: str = "",
):
    """Render the reference's five-PDF family into ``out_dir``.

    ``panels``: [(panel_title, series)] where series is
    [(label, (bwt, avg, lo, hi))] — per-lang dicts for one line/box."""
    os.makedirs(out_dir, exist_ok=True)
    x = np.arange(len(langs))
    for kind, fname, title in (
        ("line", "wer_line_plot.pdf", "WER"),
        ("shaded", "wer_shaded_plot.pdf", "WER Min/Max"),
        ("errbar", "wer_error_bars_plot.pdf", "WER Min-Avg-Max"),
        ("bwt", "bwt_plot.pdf", "Backward Transfer (BWT)"),
        ("box", "wer_box_plot.pdf", "WER Box Plot"),
    ):
        fig, axs = _grid(len(panels))
        for ax, (panel_title, series) in zip(axs, panels):
            if kind == "box":
                _draw_box(
                    ax, [(lbl, av) for lbl, (_, av, _, _) in series], langs
                )
            else:
                _draw_series(
                    ax,
                    kind,
                    [
                        (lbl, bwt if kind == "bwt" else av, lo, hi)
                        for lbl, (bwt, av, lo, hi) in series
                    ],
                    x, langs,
                )
            ax.title = panel_title
        axs[0].ylabel = "BWT" if kind == "bwt" else "WER"
        fig.title = title + title_suffix
        fig.save(os.path.join(out_dir, fname))


def plot_stats(
    runs: dict[str, list[dict]], out_dir: str, decoder: str = "rnnt",
    metrics=("avg",), split: str = "val", languages=None,
):
    """Reference `updated_plot_stats` (results.py:433-680): five PDFs in
    ``out_dir``; one panel per metric variant, one line/box per run."""
    scores = {
        m: calc_scores(runs, decoder, m, split, languages) for m in metrics
    }
    langs = _score_langs(scores[metrics[0]][1], languages)
    if not langs:
        return
    panels = []
    for m in metrics:
        bwt, av, lo, hi = scores[m]
        panels.append((
            f"{METRIC_TITLES[m]} WER",
            [
                (run, (bwt.get(run, {}), av[run], lo.get(run, {}),
                       hi.get(run, {})))
                for run in runs if run in av
            ],
        ))
    _render_family(out_dir, panels, langs)


def plot_stats_multi(
    runs: dict[str, list[dict]], out_dir: str, decoder: str = "rnnt",
    split: str = "val", languages=None, metrics=("", "noisy"),
):
    """Reference `updated_plot_stats_multi` (results.py:700-934): five PDFs;
    one panel PER RUN, normal-vs-noisy lines inside each panel."""
    scores = {
        m: calc_scores(runs, decoder, m, split, languages) for m in metrics
    }
    langs = _score_langs(scores[metrics[0]][1], languages)
    if not langs:
        return
    panels = []
    for run in runs:
        series = []
        for m in metrics:
            bwt, av, lo, hi = scores[m]
            if run in av:
                series.append((
                    METRIC_TITLES[m],
                    (bwt.get(run, {}), av[run], lo.get(run, {}),
                     hi.get(run, {})),
                ))
        panels.append((run, series))
    _render_family(out_dir, panels, langs, " (Normal vs Noisy)")


def generate_report(
    run_dirs: dict[str, str], out_dir: str, languages=None,
    families: dict[str, list[str]] | None = None,
) -> dict:
    """Full pipeline: run dirs -> summary json + PDF families
    (reference results.py:1003-1086).

    Emits the reference's result-dir structure: `{rnnt,ctc}_benchmark/`
    (all runs, avg metric), `all_comparison_noisy/` (per-run
    normal-vs-noisy panels), plus one `<name>_ablation/` dir per entry in
    ``families`` ({name: [run-name substrings]}) — e.g.
    {"ewc": ["ewc", "naive"]} reproduces `ewc_ablation/`. Epoch sweeps are
    the same mechanism with runs named per epoch count
    (`*_epoch_vs_wer/` in the reference results tree)."""
    os.makedirs(out_dir, exist_ok=True)
    runs = {
        name: load_run_metrics(os.path.join(d, "metrics.jsonl"))
        for name, d in run_dirs.items()
    }
    summaries = {
        name: summarize_run(recs, languages) for name, recs in runs.items()
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summaries, f, indent=2)
    for dec in ("rnnt", "ctc"):
        plot_wer_vs_task(
            runs, os.path.join(out_dir, f"{dec}_wer_vs_task.pdf"),
            decoder=dec, languages=languages,
        )
        plot_bwt(
            runs, os.path.join(out_dir, f"{dec}_bwt.pdf"), decoder=dec,
            languages=languages,
        )
        plot_box(
            runs, os.path.join(out_dir, f"{dec}_box.pdf"), decoder=dec,
            languages=languages,
        )
        plot_stats(
            runs, os.path.join(out_dir, f"{dec}_benchmark"), decoder=dec,
            metrics=("avg",), languages=languages,
        )
    plot_stats_multi(
        runs, os.path.join(out_dir, "all_comparison_noisy"),
        languages=languages,
    )
    for fam, patterns in (families or {}).items():
        sel = {
            name: recs for name, recs in runs.items()
            if any(p in name for p in patterns)
        }
        if sel:
            plot_stats(
                sel, os.path.join(out_dir, f"{fam}_ablation"),
                metrics=("avg",), languages=languages,
            )
    return summaries
