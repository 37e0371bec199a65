"""Learning without Forgetting: per-batch teacher/student distillation
(PyTorch).

Port of indic_cl_asr_tpu/cl/lwf.py (reference cl_baseline_lwf.py:207-265):
for every batch of task t > 0 the previous task's weights act as a frozen
teacher, held as a second model in memory (the reference reloads them from
disk every batch), and

    ctc_kd  = KL(teacher_ctc || student_ctc)     'batchmean' over B
    rnnt_kd = KL(teacher_joint || student_joint) 'batchmean'
    loss = (1 - kd) * task + kd * ((1 - kd_ctx) * rnnt_kd + kd_ctx * ctc_kd)

Both joints get a log-softmax before the KL unless ``faithful_raw_logits``
reproduces the reference's raw-logit KL. The joint KD is chunked over T
with ``torch.utils.checkpoint`` per chunk; its products are plain
``torch.matmul`` (outside any Pallas kernel in the JAX package). Over a
model split by parallel/sharding.py the teacher is split as the student
is.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.rnnt_loss import row_count
from ..parallel.sharding import is_sharded, shard_model
from .mas import _valid_frames, joint_logits


@dataclasses.dataclass
class LwFConfig:
    knowledge_distillation: float = 0.1       # kd weight
    knowledge_distillation_ctx: float = 1.0   # kd_ctx: ctc share
    faithful_raw_logits: bool = False
    # storage dtype of the teacher's parameters and BatchNorm statistics;
    # "bfloat16" halves its memory, and a bf16 model computes in bf16 anyway
    teacher_dtype: str = "float32"


@torch.no_grad()
def end_task(model: torch.nn.Module, teacher_dtype: str = "float32") -> torch.nn.Module:
    """The just-trained model as the next task's teacher: a second model
    of the same config on the same device, with copies of the parameters
    and BatchNorm statistics, stored in ``teacher_dtype``, split as
    ``model`` is; nothing in it takes a gradient."""
    teacher = type(model)(model.cfg, device=model.device)
    if is_sharded(model):
        shard_model(teacher, model.mesh)
    teacher.load_state_dict(model.state_dict())
    return teacher.to(getattr(torch, teacher_dtype))


def ctc_kd_loss(student_logprobs, teacher_logprobs, row_mask=None, n_rows=None):
    """KL(teacher || student) with torch kl_div(input=student_logprob,
    target=teacher_prob, reduction='batchmean') semantics: sum / B
    (cl_baseline_lwf.py:242-246); ``row_mask`` leaves out a final bucket
    batch's repeat rows, and the sum is divided by
    ``ops/rnnt_loss.py:row_count(row_mask, n_rows, B)``."""
    t = teacher_logprobs.detach().float()
    s = student_logprobs.float()
    kl = torch.exp(t) * (t - s)
    if row_mask is not None:
        kl = torch.where(row_mask.reshape((-1,) + (1,) * (kl.dim() - 1)), kl, 0.0)
    return kl.sum() / row_count(row_mask, n_rows, student_logprobs.shape[0])


def joint_kd_chunked(f_proj_s, g_proj_s, f_proj_t, g_proj_t, head_w_s, head_b_s,
                     head_w_t, head_b_t, *, activation: str = "relu",
                     chunk_size: int = 64, faithful_raw_logits: bool = False,
                     row_mask=None, uniform_head: bool = False, n_rows=None):
    """Chunked KL(teacher joint || student joint), 'batchmean' over B
    (cl_baseline_lwf.py:248-259). Frames added by chunk padding and repeat
    rows are masked out; the in-bucket T/U padding stays in. ``n_rows``
    as in ``ctc_kd_loss``."""
    B, T, H = f_proj_s.shape
    n_chunks = -(-T // chunk_size)
    pad = n_chunks * chunk_size - T
    if pad:
        f_proj_s = F.pad(f_proj_s, (0, 0, 0, pad))
        f_proj_t = F.pad(f_proj_t, (0, 0, 0, pad))

    def chunk_kd(f_s, f_t, g_s, g_t, w_s, b_s, w_t, b_t, ci):
        s = joint_logits(f_s, g_s, w_s, b_s, activation, uniform_head)
        t = joint_logits(f_t, g_t, w_t, b_t, activation, uniform_head).detach()
        if not faithful_raw_logits:
            s = torch.log_softmax(s, dim=-1)
            t = torch.log_softmax(t, dim=-1)
        # torch kl_div(input=s, target=exp(t)): sum exp(t) * (t - s)
        kl = (torch.exp(t) * (t - s)).sum(dim=(2, 3))  # [B, Tc]
        return _valid_frames(kl, ci, chunk_size, T, row_mask).sum()

    total = 0.0
    for ci in range(n_chunks):
        sl = slice(ci * chunk_size, (ci + 1) * chunk_size)
        total = total + checkpoint(
            chunk_kd, f_proj_s[:, sl], f_proj_t[:, sl], g_proj_s, g_proj_t, head_w_s,
            head_b_s, head_w_t, head_b_t, ci, use_reentrant=False)
    return total / row_count(row_mask, n_rows, B)
