"""WER and continual-learning metrics (own copy of the framework-free
indic_cl_asr_tpu/train/metrics.py).

  * WER = sum(edit_distance(hyp_words, ref_words)) / sum(len(ref_words))
    over the eval set (reference utils.py:120-145 `compute_wer`);
  * perf matrix P[step, lang] of WERs after each task
    (utils.py:179-190 `compute_perf_matrix`);
  * BWT curves: for language i trained at task i,
    bwt(i, t) = P[i, i] - P[t, i] for t > i (utils.py:192-209
    `compute_bwt_new`); scalar per-task BWT =
    sum_{i<t}(P[i][i] - P[t][i]) / max(t, 1) (results.py:385-392).

``edit_distance`` is the native host library's (``utils/native.py``), as
in the JAX package; ``edit_distance_py`` is its plain version.
"""

from __future__ import annotations

import numpy as np

from ..utils.native import edit_distance_native as edit_distance


def edit_distance_py(a: list, b: list) -> int:
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, y in enumerate(b, 1):
            cur[j] = min(
                prev[j] + 1,          # deletion
                cur[j - 1] + 1,       # insertion
                prev[j - 1] + (x != y),  # substitution
            )
        prev = cur
    return prev[-1]


def wer(refs: list[str], hyps: list[str]) -> float:
    """Aggregate word error rate (reference utils.py:129-145)."""
    total_errors = 0
    total_words = 0
    for ref, hyp in zip(refs, hyps):
        ref_words = ref.strip().split()
        hyp_words = hyp.strip().split()
        total_errors += edit_distance(hyp_words, ref_words)
        total_words += len(ref_words)
    return total_errors / total_words if total_words else 0.0


def compute_perf_matrix(
    val_performance: dict[str, list[dict]], metric: str = "rnnt_wer"
) -> tuple[np.ndarray, list[str]]:
    """{lang: [record-per-task, ...]} -> [n_steps, n_langs] matrix (NaN where
    a language wasn't evaluated yet)."""
    langs = list(val_performance.keys())
    max_len = max((len(v) for v in val_performance.values()), default=0)
    perf = np.full((max_len, len(langs)), np.nan)
    for j, lang in enumerate(langs):
        for i, record in enumerate(val_performance[lang]):
            perf[i, j] = record[metric]
    return perf, langs


def compute_bwt_curves(
    val_perf: dict[str, list[dict]], metric: str = "rnnt_wer"
) -> dict[str, list[tuple[int, float]]]:
    """Per-language (task_index_1based, wer_ii - wer_ti) points."""
    langs = list(val_perf.keys())
    curves: dict[str, list[tuple[int, float]]] = {l: [] for l in langs}
    for i, lang in enumerate(langs):
        if i >= len(val_perf[lang]):
            continue
        wer_ii = val_perf[lang][i][metric]
        for t in range(i + 1, len(langs)):
            if t < len(val_perf[lang]):
                curves[lang].append((t + 1, wer_ii - val_perf[lang][t][metric]))
    return curves


def bwt_scores(perf: np.ndarray) -> np.ndarray:
    """Scalar BWT per task t over a [step, lang] matrix:
    sum_{i<t}(P[i, i] - P[t, i]) / max(t, 1)."""
    n = perf.shape[1]
    out = np.zeros(n)
    for t in range(n):
        acc = 0.0
        for i in range(t):
            acc += perf[i][i] - perf[t][i]
        out[t] = acc / max(t, 1)
    return out
