"""CL method adapters for the sequence driver (PyTorch).

Port of indic_cl_asr_tpu/cl/methods.py. Each adapter owns its algorithm's
state across tasks and plugs into train/driver.py through the
``CLMethod`` hooks:

  * ``penalty_fn(task_idx)`` for train/step.py's hook: EWC's penalty
    enters as extra gradients, MAS's as a loss term;
  * the "+1 importance epoch": EWC accumulates the Fisher from a train-mode
    forward and backward of the task loss, MAS the |gradient| of the
    output-energy surrogate; neither keeps the BatchNorm statistics of
    those forwards (``batch_stats_frozen``), as the JAX package discards
    the ``batch_stats`` they return;
  * LwF replaces the step: one student forward feeds the task loss and the
    distillation, the teacher runs a train-mode forward with its own
    draws, its BatchNorm statistics fixed.

The JAX package's ``penalty_tree`` only keeps large pytrees out of a jit
program's constants; eager PyTorch needs no such path.

Under run_sequence's data mesh (``self.mesh``, which it sets) every
forward here takes the global batch's BatchNorm statistics, every mean
divides by the global count, and the importance epochs accumulate from
the globally summed loss and gradients (the square and the absolute
value do not commute with the sum over the ranks). Over a model split
by parallel/sharding.py the states hold the parameters' shards; they are
exported whole (``gather_named``, every rank calls it) and imported as
this rank's shards.
"""

from __future__ import annotations

import torch

from ..audio.features import log_mel_spectrogram
from ..models.conformer import batch_stats_frozen
from ..parallel.sharding import gather_named, gather_state, local_named
from ..train.driver import CLMethod
from ..train.step import (StepConfig, batch_rows, data_parallel, hybrid_forward_loss,
                          hybrid_forward_tensors, reduced)
from ..utils.profiling import span
from . import ewc as E
from . import lwf as L
from . import mas as M


def _global_grads(mesh, out, names, params):
    """({name: d out / d param}, out), each summed over the data ranks."""
    grads, aux = reduced(mesh, torch.autograd.grad(out, params, allow_unused=True), params,
                         {"out": out})
    return ({n: (torch.zeros_like(p) if g is None else g.detach())
             for n, p, g in zip(names, params, grads)}, aux["out"].detach())


class NaiveMethod(CLMethod):
    name = "naive"


class _ImportanceMethod(CLMethod):
    """EWC and MAS: a penalty against theta* of the previous task, an
    importance epoch after each task's training."""

    def __init__(self, cfg, model, step_cfg: StepConfig, optimizer):
        self.cfg, self.model, self.step_cfg = cfg, model, step_cfg
        self.names, self.params = list(optimizer.names), list(optimizer.params)

    def wants_importance_epoch(self) -> bool:
        return True

    def begin_importance(self):
        return {n: torch.zeros_like(p) for n, p in zip(self.names, self.params)}

    def _named_params(self) -> dict:
        return dict(zip(self.names, self.params))


class EWCMethod(_ImportanceMethod):
    """cl_baseline_ewc.py semantics; see cl/ewc.py."""

    name = "ewc"

    def __init__(self, cfg: E.EWCConfig, model, step_cfg: StepConfig, optimizer):
        super().__init__(cfg, model, step_cfg, optimizer)
        self.state = E.EWCState()

    def penalty_fn(self, task_idx: int):
        return None if task_idx == 0 else E.make_penalty_fn(self.cfg, self.state)

    def importance_batch(self, acc, batch: dict, generator: torch.Generator):
        """fish += loss·grad² of a train-mode forward (dither, SpecAugment,
        dropout as in training), its BatchNorm statistics not kept."""
        with data_parallel(self.mesh, generator, self.model.device, self.model) as rngs, \
                batch_stats_frozen(self.model):
            loss, _ = hybrid_forward_loss(self.model, self.step_cfg, batch, rngs, train=True)
        grads, loss = _global_grads(self.mesh, loss, self.names, self.params)
        return E.accumulate_fisher(acc, grads, loss)

    def end_task(self, acc, n_batches: int, total_utterances: int) -> None:
        self.state = E.end_task(self.cfg, self.state, acc, max(total_utterances, 1),
                                self._named_params())

    def export_state(self):
        if self.state.main_fish is None:
            return None
        return {"main_fish": gather_named(self.model, self.state.main_fish),
                "checkpoint": gather_named(self.model, self.state.checkpoint)}

    def import_state(self, tree) -> None:
        if tree is not None:
            self.state = E.EWCState(main_fish=local_named(self.model, tree["main_fish"]),
                                    checkpoint=local_named(self.model, tree["checkpoint"]))


class MASMethod(_ImportanceMethod):
    """cl_baseline_mas.py semantics; see cl/mas.py."""

    name = "mas"

    def __init__(self, cfg: M.MASConfig, model, step_cfg: StepConfig, optimizer):
        super().__init__(cfg, model, step_cfg, optimizer)
        self.state = M.MASState()

    def penalty_fn(self, task_idx: int):
        return None if task_idx == 0 else M.make_penalty_fn(self.cfg, self.state)

    def importance_batch(self, acc, batch: dict, generator: torch.Generator):
        """Omega += |d surrogate| with the JAX package's modes: log-mel
        without dither, the encoder in train mode (dropout, batch
        statistics, not kept), the prediction net in eval mode."""
        model, step_cfg = self.model, self.step_cfg
        lang = batch["lang_ids"].long()
        model.train(True)
        model.prediction.eval()
        with data_parallel(self.mesh, generator, model.device, model) as rngs, \
                batch_stats_frozen(model):
            mel, mel_lens = log_mel_spectrogram(batch["audio"], batch["audio_len"],
                                                step_cfg.frontend, training=False)
            f, _ = model.encode(mel, mel_lens, rngs)
            g, _ = model.predict(batch["tokens"], add_sos=True)
            f_proj, g_proj = model.joint_project(f, g)
            _, ctc_logits = model.ctc_logprobs(f, lang, return_logits=True)
            row_mask, n_rows = batch_rows(batch, f.shape[0], f.device)
            head_kernel, head_bias = model.joint.heads()
            surrogate = M.mas_surrogate(
                self.cfg, f_proj, g_proj, head_kernel[lang], head_bias[lang], ctc_logits,
                activation=model.cfg.joint_activation, chunk_size=step_cfg.rnnt_chunk_size,
                row_mask=row_mask, n_rows=n_rows, uniform_head=step_cfg.uniform_lang_head)
        grads, _ = _global_grads(self.mesh, surrogate, self.names, self.params)
        return M.accumulate_importance(acc, grads)

    def end_task(self, acc, n_batches: int, total_utterances: int) -> None:
        self.state = M.end_task(self.state, acc, max(n_batches, 1), self._named_params())

    def export_state(self):
        if self.state.importance is None:
            return None
        return {"importance": gather_named(self.model, self.state.importance),
                "checkpoint": gather_named(self.model, self.state.checkpoint)}

    def import_state(self, tree) -> None:
        if tree is not None:
            self.state = M.MASState(importance=local_named(self.model, tree["importance"]),
                                    checkpoint=local_named(self.model, tree["checkpoint"]))


class LwFMethod(CLMethod):
    """cl_baseline_lwf.py semantics; see cl/lwf.py. From the second task on
    the step is task loss + teacher/student distillation."""

    name = "lwf"

    def __init__(self, cfg: L.LwFConfig, model, step_cfg: StepConfig, optimizer):
        self.cfg, self.model, self.step_cfg, self.optimizer = cfg, model, step_cfg, optimizer
        self.teacher = None

    def make_train_step(self, base_builder, task_idx: int):
        if task_idx == 0 or self.teacher is None:
            return base_builder(None)
        model, teacher, step_cfg, lcfg = self.model, self.teacher, self.step_cfg, self.cfg
        optimizer = self.optimizer
        params = optimizer.params

        mesh = self.mesh

        def step(batch: dict, generator: torch.Generator) -> dict:
            with data_parallel(mesh, generator, model.device, model, teacher) as rngs:
                rngs_teacher = rngs.fork()
                task_loss, aux, (fs, gs, ctc_s, hws, hbs) = hybrid_forward_loss(
                    model, step_cfg, batch, rngs, train=True, return_pieces=True)
                # the teacher: a train-mode forward with its own draws
                # (cl_baseline_lwf.py:227-228), its BatchNorm statistics fixed
                with torch.no_grad(), batch_stats_frozen(teacher):
                    ft, gt, ctc_t, hwt, hbt, _, _ = hybrid_forward_tensors(
                        teacher, step_cfg, batch["audio"], batch["audio_len"],
                        batch["tokens"], batch["lang_ids"], rngs_teacher, True,
                        batch.get("audio_len_host"), batch.get("row0", 0))
            row_mask, n_rows = batch_rows(batch, fs.shape[0], fs.device)
            ctc_kd = L.ctc_kd_loss(ctc_s, ctc_t, row_mask=row_mask, n_rows=n_rows)
            rnnt_kd = L.joint_kd_chunked(
                fs, gs, ft, gt, hws, hbs, hwt, hbt, activation=model.cfg.joint_activation,
                chunk_size=step_cfg.rnnt_chunk_size,
                faithful_raw_logits=lcfg.faithful_raw_logits, row_mask=row_mask,
                n_rows=n_rows, uniform_head=step_cfg.uniform_lang_head)
            kd, ctx = lcfg.knowledge_distillation, lcfg.knowledge_distillation_ctx
            loss = (1 - kd) * task_loss + kd * ((1 - ctx) * rnnt_kd + ctx * ctc_kd)
            aux = dict(aux, train_loss=loss, rnnt_kd=rnnt_kd, ctc_kd=ctc_kd)
            with span("asr.backward"):
                grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads, aux = reduced(mesh, grads, params, aux)
            with span("asr.optimizer"):
                optimizer.step(list(grads))
            return {k: v.detach() for k, v in aux.items()}

        return step

    def end_task(self, acc, n_batches: int, total_utterances: int) -> None:
        self.teacher = L.end_task(self.model, self.cfg.teacher_dtype)

    def export_state(self):
        return None if self.teacher is None else {"teacher": gather_state(self.teacher)["model"]}

    def import_state(self, tree) -> None:
        if tree is not None:
            self.teacher = L.end_task(self.model, self.cfg.teacher_dtype)
            self.teacher.load_state_dict(local_named(self.teacher, tree["teacher"]))
