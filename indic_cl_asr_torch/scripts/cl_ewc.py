"""EWC over the language sequence (reference: cl_baseline_ewc.py).

The Fisher accumulates over the +1 importance epoch; the quadratic
penalty enters as gradients during the training epochs (cl/ewc.py).
"""

from ..cl.ewc import EWCConfig
from ..cl.methods import EWCMethod
from ._common import build_all, run, setup


def main(argv=None):
    cfg, ns = setup(argv, notes_default="ewc")
    ctx = build_all(cfg, ns)
    method = EWCMethod(
        EWCConfig(e_lambda=cfg.cl_config.e_lambda, e_gamma=cfg.cl_config.e_gamma),
        ctx["model"], ctx["step_cfg"], ctx["optimizer"],
    )
    return run(ctx, method)


if __name__ == "__main__":
    main()
