"""Naive sequential fine-tuning over the language sequence (reference:
cl_baseline.py:70-249): the task loop, eval matrix, BWT logging and
partial saves of train/driver.py:run_sequence.

Usage:
  python -m indic_cl_asr_torch.scripts.cl_baseline --notes "run 1" --epochs 2 \\
      --dataset.annotation_path dataset.pkl --dataset.path /data/indicsuperb
"""

from ..cl.methods import NaiveMethod
from ._common import build_all, run, setup


def main(argv=None):
    cfg, ns = setup(argv)
    return run(build_all(cfg, ns), NaiveMethod())


if __name__ == "__main__":
    main()
