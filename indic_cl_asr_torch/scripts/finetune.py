"""Non-CL control: naive fine-tuning over a short language sequence with
periodic eval (reference: finetune.py:68-248, hindi -> tamil, evaluating
every N epochs), on finetune_config.yaml."""

import os

from ..cl.methods import NaiveMethod
from ._common import build_all, run, setup

CONFIG = os.path.join(os.path.dirname(__file__), "finetune_config.yaml")


def main(argv=None):
    cfg, ns = setup(argv, config_path=CONFIG, notes_default="finetune")
    return run(build_all(cfg, ns), NaiveMethod())


if __name__ == "__main__":
    main()
