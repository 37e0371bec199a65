"""LwF over the language sequence (reference: cl_baseline_lwf.py).

The teacher is the previous task's model held in device memory; the KD
term mixes the chunked joint KL and the CTC KL per
cl_baseline_lwf.py:242-264 (cl/lwf.py).
"""

from ..cl.lwf import LwFConfig
from ..cl.methods import LwFMethod
from ._common import build_all, run, setup


def main(argv=None):
    cfg, ns = setup(argv, notes_default="lwf")
    ctx = build_all(cfg, ns)
    cl = cfg.cl_config
    method = LwFMethod(
        LwFConfig(
            knowledge_distillation=cl.knowledge_distillation,
            knowledge_distillation_ctx=cl.knowledge_distillation_ctx,
            faithful_raw_logits=getattr(cl, "faithful_raw_logits", False),
            teacher_dtype=getattr(cl, "teacher_dtype", "float32"),
        ),
        ctx["model"], ctx["step_cfg"], ctx["optimizer"],
    )
    return run(ctx, method)


if __name__ == "__main__":
    main()
