"""Word error rate (own copy of the framework-free metrics).

WER = sum(edit_distance(hyp_words, ref_words)) / sum(len(ref_words)) over
the eval set (reference utils.py:120-145 `compute_wer`). The continual-
learning matrix metrics arrive with the CL-driver slice.
"""

from __future__ import annotations


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
        total_errors += edit_distance_py(hyp_words, ref_words)
        total_words += len(ref_words)
    return total_errors / total_words if total_words else 0.0
