"""The continual-learning sequence driver (PyTorch).

Port of indic_cl_asr_tpu/train/driver.py: one loop over the languages,
parameterised by a CL method object (cl/methods.py). Per task:

  build the task's batches -> epochs of train steps
  -> eval over every language seen so far (val and test, clean and noisy,
     greedy RNNT and CTC), BEFORE the importance epoch (the reference's
     timing, cl_baseline_ewc.py:288)
  [EWC/MAS: one importance epoch with no optimizer update]
  -> BWT curves -> a trainable-only weight save -> a task checkpoint.

Randomness: one CPU generator seeded with ``cfg.seed`` hands every train
step and importance batch a fresh generator of its own (the JAX package
splits one key the same way: the port matches its draws in distribution,
not in value). The data order is the pipeline's, seeded with
``cfg.seed + task``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch

from ..data.manifest import ManifestEntry
from ..data.pipeline import BatchPipeline, BucketSpec
from ..device import resolve_device
from ..parallel.distributed import barrier
from ..parallel.sharding import gather_state, is_sharded, place_batch
from ..utils.checkpoint import SequenceCheckpointer, save_partial
from . import metrics as M
from .eval import Transcriber, run_eval
from .logger import Logger
from .state import AdamW
from .step import StepConfig, batch_to_device_dict, make_train_step

LANGUAGES = [
    "hindi", "bengali", "marathi", "telugu", "tamil", "urdu",
    "gujarati", "kannada", "odia", "malayalam", "punjabi", "sanskrit",
]
SHORT_FORM = [
    "hi", "bn", "mr", "te", "ta", "ur", "gu", "kn", "or", "ml", "pa", "sa",
]


@dataclasses.dataclass
class TaskData:
    train: Sequence[ManifestEntry]
    val_clean: Sequence[ManifestEntry]
    val_noisy: Sequence[ManifestEntry]
    test_clean: Sequence[ManifestEntry]
    test_noisy: Sequence[ManifestEntry]


class CLMethod:
    """Interface of the CL algorithms the driver runs (naive by default).
    ``mesh`` is the run's data mesh (None: one process), set by
    ``run_sequence`` for the steps and importance batches it builds."""

    name = "naive"
    mesh = None

    def penalty_fn(self, task_idx: int):
        """Penalty hook of the train step ({name: param} -> (loss, grads))."""
        return None

    def make_train_step(self, base_builder: Callable, task_idx: int):
        """The step for task ``task_idx``; ``base_builder(penalty_fn)`` is
        train/step.py's make_train_step over the run's model and optimizer."""
        return base_builder(self.penalty_fn(task_idx))

    def wants_importance_epoch(self) -> bool:
        return False

    def begin_importance(self):
        return None

    def importance_batch(self, acc, batch: dict, generator: torch.Generator):
        return acc

    def end_task(self, acc, n_batches: int, total_utterances: int) -> None:
        pass

    def export_state(self):
        """The algorithm's state to checkpoint with the task (None =
        stateless), restored by import_state on resume: without it a
        resumed EWC/MAS/LwF sequence would continue as naive fine-tuning."""
        return None

    def import_state(self, tree) -> None:
        pass


@dataclasses.dataclass
class DriverConfig:
    batch_size: int = 16
    epochs: int = 1
    seed: int = 42
    n_langs: int = 9
    save_weights: bool = True
    output_dir: str = "outputs"
    evaluate_every_n_epochs: int = 0  # 0 = only at the end of a task
    bucket_spec: BucketSpec | None = None


def _fresh_generator(root: torch.Generator) -> torch.Generator:
    return torch.Generator().manual_seed(int(torch.randint(0, 2**62, (1,), generator=root)))


def run_sequence(
    *,
    cfg: DriverConfig,
    model: torch.nn.Module,
    step_cfg: StepConfig,
    optimizer: AdamW,
    method: CLMethod,
    task_data: dict[str, TaskData],
    tokenizer,
    logger: Logger,
    transcriber: Transcriber | None = None,
    checkpointer: SequenceCheckpointer | None = None,
    languages: Sequence[str] | None = None,
    mesh=None,
    device=None,
) -> dict:
    """Sequential CL over languages, training ``model`` in place through
    ``optimizer`` (train/state.py, whose parameters are the trainable
    ones). Returns {"val": {lang: [perf record per task]}, "test": ...}.

    ``device`` defaults to the CUDA card and must be the model's (``"cpu"``
    for the plain path).

    ``mesh`` (parallel/sharding.py:make_mesh, one process a device): every
    process runs this same loop over the identical global batches, keeps
    its rows of each (``place_batch``) and steps data parallel; eval and
    the importance epochs' counts are replicated. The main process writes
    the partial weights and the task checkpoints, then a barrier; a
    resume loads on every process.

    A model split over ``mesh``'s model axis (parallel/sharding.py:
    shard_model) trains split; every rank evaluates a whole copy gathered
    from the shards before each eval (``Transcriber`` and the fused
    decode take whole weights), where the JAX package evaluates the split
    program: the values are the same."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, run_sequence asked for {dev}")
    languages = list(languages or LANGUAGES[: cfg.n_langs])
    split = is_sharded(model)
    if split and transcriber is not None and transcriber.model is model:
        raise ValueError("a split model decodes through a whole copy: pass a transcriber "
                         "over another model of the same config, or none")
    transcriber = transcriber or Transcriber(
        model=type(model)(model.cfg, device=model.device) if split else model,
        tokenizer=tokenizer, languages=languages, frontend=step_cfg.frontend,
        batch_size=cfg.batch_size, bucket_spec=cfg.bucket_spec,
    )

    def eval_all(lang_idx, epoch, record):
        if split:  # every rank: the whole model from the shards
            transcriber.model.load_state_dict(gather_state(model)["model"])
        _eval_all(logger, transcriber, task_data, languages, lang_idx, epoch,
                  val_performance, test_performance, record=record)

    val_performance: dict[str, list] = {l: [] for l in languages}
    test_performance: dict[str, list] = {l: [] for l in languages}
    root = torch.Generator().manual_seed(cfg.seed)
    method.mesh = mesh

    def base_builder(penalty_fn):
        return make_train_step(model, step_cfg, optimizer, penalty_fn, device=dev, mesh=mesh)

    start_idx = 0
    if checkpointer is not None:
        latest = checkpointer.latest_task()
        if latest is not None:
            idx, lang = latest
            checkpointer.load_task(idx, lang, model, optimizer)
            method.import_state(checkpointer.load_method_state(idx, lang, dev))
            for l, recs in checkpointer.manifest()["val_performance"].items():
                if l in val_performance:
                    val_performance[l] = recs
            start_idx = idx + 1
            logger.log({"resumed_from_task": idx, "resumed_lang": lang})

    def to_device(b):
        # the loss applies lang_ids[0]'s head to the whole batch under
        # uniform_lang_head: check on the host that the batch is one language
        if step_cfg.uniform_lang_head and (b.lang_ids != b.lang_ids[0]).any():
            raise ValueError(
                "uniform_lang_head=True but the batch mixes languages "
                f"({sorted(set(b.lang_ids.tolist()))}); set "
                "uniform_lang_head=False for mixed batches")
        if mesh is None:
            return batch_to_device_dict(b, dev)
        return place_batch(batch_to_device_dict(b, "cpu"), mesh, dev)

    for lang_idx in range(start_idx, len(languages)):
        lang = languages[lang_idx]
        data = task_data[lang]
        step = method.make_train_step(base_builder, lang_idx)
        pipe = BatchPipeline(data.train, tokenizer, languages, cfg.batch_size,
                             spec=cfg.bucket_spec, shuffle=True, seed=cfg.seed + lang_idx)

        for epoch in range(cfg.epochs):
            t0 = time.time()
            n_utts = 0
            for batch in pipe:
                aux = step(to_device(batch), _fresh_generator(root))
                n_utts += batch.n_real
                logger.log({f"train/{k}_{lang}": v for k, v in aux.items()}
                           | {"epoch": epoch, "lang": lang_idx})
            logger.log_epoch_average()
            dt = time.time() - t0
            logger.log({f"train/epoch_time_{lang}": dt,
                        f"train/utts_per_sec_{lang}": n_utts / max(dt, 1e-9)})
            if (cfg.evaluate_every_n_epochs
                    and (epoch + 1) % cfg.evaluate_every_n_epochs == 0
                    and epoch != cfg.epochs - 1):
                eval_all(lang_idx, epoch, record=False)

        # eval BEFORE the importance epoch (reference timing)
        eval_all(lang_idx, cfg.epochs - 1, record=True)

        if method.wants_importance_epoch():
            acc = method.begin_importance()
            n_batches = total_utts = 0
            for batch in pipe:
                acc = method.importance_batch(acc, to_device(batch), _fresh_generator(root))
                n_batches += 1
                total_utts += batch.n_real
            method.end_task(acc, n_batches, total_utts)
        else:
            method.end_task(None, 0, 0)

        # BWT curves after each task (utils.py:213-243 / cl_baseline.py:220-243)
        curves = M.compute_bwt_curves(val_performance)
        for l, pts in curves.items():
            for t, b in pts:
                logger.log({f"bwt/{l}": b, "bwt_task": t})
        logger.log_bwt_curves(curves)

        if cfg.save_weights:
            # every process gathers a split model, the main process writes
            save_partial(f"{logger.dir}/model_{lang}.npz", model, optimizer.names)
            barrier("partial save")
        if checkpointer is not None:
            checkpointer.save_task(lang_idx, lang, model, optimizer, val_performance,
                                   method_state=method.export_state())

    return {"val": val_performance, "test": test_performance}


def _eval_all(logger, transcriber, task_data, languages, lang_idx, epoch,
              val_performance, test_performance, record: bool):
    for i in range(lang_idx + 1):
        lang = languages[i]
        data = task_data[lang]
        perf_v = run_eval(logger, "val", transcriber, data.val_clean, data.val_noisy,
                          epoch, lang_idx, lang)
        perf_t = run_eval(logger, "test", transcriber, data.test_clean, data.test_noisy,
                          epoch, lang_idx, lang)
        if record:
            val_performance[lang].append(perf_v)
            test_performance[lang].append(perf_t)
