"""MAS over the language sequence (reference: cl_baseline_mas.py).

Importance = |grad| of the output-energy surrogate, accumulated in the +1
epoch; the quadratic penalty is added to the loss during the training
epochs (cl/mas.py).
"""

from ..cl.mas import MASConfig
from ..cl.methods import MASMethod
from ._common import build_all, run, setup


def main(argv=None):
    cfg, ns = setup(argv, notes_default="mas")
    ctx = build_all(cfg, ns)
    method = MASMethod(
        MASConfig(mas_lambda=cfg.cl_config.mas_lambda, mas_ctx=cfg.cl_config.mas_ctx),
        ctx["model"], ctx["step_cfg"], ctx["optimizer"],
    )
    return run(ctx, method)


if __name__ == "__main__":
    main()
