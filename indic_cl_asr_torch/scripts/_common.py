"""Shared wiring of the port's experiment drivers (cl_*.py, finetune.py).

Port of the JAX package's scripts/_common.py: config + CLI overrides,
data, tokenizer, model, optimizer, logger, checkpointer. Data comes from
(in priority order):
  1. --dataset.manifest_dir: per-language JSONL manifests
     ({lang}_{train|val|test|noisy_val|noisy_test}.jsonl)
  2. --dataset.annotation_path: the reference's pickled annotation dict
     (dataset_gen.ipynb layout) + --dataset.path root
  3. --synthetic true: generated tiny wav dataset (smoke runs, no data
     download needed)

Besides the config's leaves every driver takes ``--notes`` and
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
path, and without a card nothing runs unless it is given).
``model.scan_layers`` is accepted and ignored: the port has one layer
layout.

Several processes, one device each: ``INDIC_ASR_MULTIHOST=1`` joins the
process group, from ``INDIC_ASR_COORDINATOR`` (host:port),
``INDIC_ASR_NUM_PROCESSES`` and ``INDIC_ASR_PROCESS_ID``, or else from
torchrun's variables (NCCL on ``--device cuda``, gloo on ``cpu``);
``--mesh.data N --mesh.model M`` (data 0: every process / M) trains on
the N x M mesh of them: data parallel over N, the model split over M
(parallel/sharding.py:shard_model, tensor-parallel encoder, heads and
prediction net gathered at use). The main process writes the synthetic
data, ``config.json`` and the tokenizer, the others wait at a barrier.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..audio.features import FrontendConfig
from ..audio.spec_augment import SpecAugmentConfig
from ..data.manifest import entries_from_annotation, load_annotation, read_manifest
from ..data.pipeline import BucketSpec
from ..data.tokenizer import CharTokenizer, MultilingualTokenizer
from ..device import resolve_device
from ..models.conformer import ConformerConfig
from ..models.hybrid import HybridModelConfig, HybridRNNTCTC, init_weights_
from ..parallel.distributed import barrier, is_main_process, process_count, setup_distributed
from ..parallel.sharding import make_mesh, shard_model
from ..train.driver import LANGUAGES, DriverConfig, TaskData, run_sequence
from ..train.logger import Logger
from ..train.state import make_optimizer
from ..train.step import StepConfig
from ..utils.checkpoint import SequenceCheckpointer, load_model
from ..utils.config import load_config, override_config_with_args

DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "config.yaml")


def setup(argv=None, config_path: str | None = None, notes_default: str = "",
          extra_args: dict | None = None):
    cfg = load_config(config_path or DEFAULT_CONFIG)
    cfg, ns = override_config_with_args(
        cfg, argv=argv,
        extra_args={
            "notes": {"type": str, "default": notes_default},
            "device": {"type": str, "default": "cuda"},
            **(extra_args or {}),
        },
    )
    if os.environ.get("INDIC_ASR_MULTIHOST") == "1":
        env = os.environ
        pidx, pcount = setup_distributed(
            coordinator_address=env.get("INDIC_ASR_COORDINATOR"),
            num_processes=(int(env["INDIC_ASR_NUM_PROCESSES"])
                           if env.get("INDIC_ASR_NUM_PROCESSES") else None),
            process_id=(int(env["INDIC_ASR_PROCESS_ID"])
                        if env.get("INDIC_ASR_PROCESS_ID") else None),
            auto_init=True, device=ns.device)
        print(f"# multihost: process {pidx}/{pcount}", file=sys.stderr)
    return cfg, ns


def build_languages(cfg) -> list[str]:
    return list(cfg.get("languages", LANGUAGES[: cfg.n_langs]))


def build_data(cfg, languages) -> dict[str, TaskData]:
    ds = cfg.dataset
    out: dict[str, TaskData] = {}
    if ds.get("manifest_dir"):
        for lang in languages:
            def rd(split):
                return read_manifest(os.path.join(ds.manifest_dir, f"{lang}_{split}.jsonl"))

            out[lang] = TaskData(
                train=rd("train")[: ds.get("train_size") or None],
                val_clean=rd("val"), val_noisy=rd("noisy_val"),
                test_clean=rd("test"), test_noisy=rd("noisy_test"),
            )
        return out
    if ds.get("annotation_path"):
        ann = load_annotation(ds.annotation_path)
        root = ds.get("path", "")
        for lang in languages:
            out[lang] = TaskData(
                train=entries_from_annotation(ann, "train", lang, root,
                                              limit=ds.get("train_size")),
                val_clean=entries_from_annotation(ann, "val", lang, root),
                val_noisy=entries_from_annotation(ann, "noisy_val", lang, root),
                test_clean=entries_from_annotation(ann, "test", lang, root),
                test_noisy=entries_from_annotation(ann, "noisy_test", lang, root),
            )
        return out
    if cfg.get("synthetic"):
        return build_synthetic_data(cfg, languages)
    raise ValueError("configure dataset.manifest_dir, dataset.annotation_path, or "
                     "synthetic: true")


def build_synthetic_data(cfg, languages) -> dict[str, TaskData]:
    from ..data.synth import make_wav_dataset

    root = os.path.join(cfg.output_dir, "synthetic_data")
    n = int(cfg.get("synthetic_utts", 8))
    # a shared output dir: one writer; the others read its manifests
    if is_main_process():
        data = make_wav_dataset(root, languages, n_per_lang=n * 3)
    barrier("synthetic data")
    if not is_main_process():
        data = {lang: read_manifest(os.path.join(root, f"{lang}.jsonl")) for lang in languages}
    out = {}
    for lang in languages:
        es = data[lang]
        out[lang] = TaskData(
            train=es[:n], val_clean=es[n : n + n // 2],
            val_noisy=es[n + n // 2 : 2 * n], test_clean=es[2 * n :][: n // 2],
            test_noisy=es[2 * n :][n // 2 :],
        )
    return out


def build_tokenizer(cfg, languages, task_data) -> MultilingualTokenizer:
    tok_dir = cfg.get("tokenizer_dir")
    if tok_dir and os.path.exists(os.path.join(tok_dir, "index.json")):
        return MultilingualTokenizer.load(tok_dir)
    # train char tokenizers from the training transcripts, padded to a
    # common per-language vocab size (the model requires equal slices)
    toks = {}
    for lang in languages:
        corpus = [e.text for e in task_data[lang].train if e.text]
        toks[lang] = CharTokenizer.train(corpus or ["placeholder"])
    per = max(t.vocab_size for t in toks.values())
    for t in toks.values():
        t.vocab += [f"<pad{i}>" for i in range(per - t.vocab_size)]
        t._piece_to_id = {p: i for i, p in enumerate(t.vocab)}
    agg = MultilingualTokenizer(toks)
    if tok_dir:
        if is_main_process():
            agg.save(tok_dir)
        barrier("tokenizer")
    return agg


def build_model_cfg(cfg, tokenizer, languages) -> HybridModelConfig:
    m = cfg.model
    dtype = torch.bfloat16 if cfg.get("mixed_precision", True) else torch.float32
    enc = ConformerConfig(
        feat_in=m.get("n_mels", 80),
        n_layers=m.get("n_layers", 17),
        d_model=m.get("d_model", 512),
        n_heads=m.get("n_heads", 8),
        ff_expansion_factor=m.get("ff_expansion_factor", 4),
        conv_kernel_size=m.get("conv_kernel_size", 31),
        subsampling_factor=m.get("subsampling_factor", 4),
        frozen_till=m.get("freeze_encoder_till", 12),
        # left >= 0 and right == 0 with causal_conv: cache-aware streaming
        att_context_size=(m.get("att_context_left", -1), m.get("att_context_right", -1)),
        causal_conv=m.get("causal_conv", False),
        # Longformer global tokens (eager attention whatever attn_impl says)
        global_tokens=m.get("global_tokens", 0),
        global_tokens_spacing=m.get("global_tokens_spacing", 1),
        global_attn_separate=m.get("global_attn_separate", False),
        attn_impl=m.get("attn_impl", "xla"),
        dtype=dtype,
    )
    return HybridModelConfig(
        encoder=enc,
        vocab_size_total=tokenizer.vocab_size,
        n_langs=len(languages),
        pred_hidden=m.get("pred_hidden", 640),
        joint_hidden=m.get("joint_hidden", 640),
        dtype=dtype,
    )


def build_mesh(cfg):
    """``--mesh.data N --mesh.model M`` (data 0: every process / M); None
    for 1 x 1, the one-process path. A mesh that does not cover the
    processes raises ``ValueError`` (parallel/sharding.py:make_mesh)."""
    mc = cfg.get("mesh", {})
    n_data, n_model = int(mc.get("data", 1)), int(mc.get("model", 1))
    if n_data == 1 and n_model == 1:
        return None
    mesh = make_mesh(n_data=None if n_data == 0 else n_data, n_model=n_model)
    print(f"# mesh: data={mesh.n_data} x model={mesh.n_model}", file=sys.stderr)
    return mesh


def build_all(cfg, ns) -> dict:
    mesh = build_mesh(cfg)
    device = resolve_device(ns.device)
    if device.type == "cuda" and device.index is None and process_count() > 1:
        device = torch.device("cuda", torch.cuda.current_device())  # this process's card
    languages = build_languages(cfg)
    task_data = build_data(cfg, languages)
    tokenizer = build_tokenizer(cfg, languages, task_data)
    model_cfg = build_model_cfg(cfg, tokenizer, languages)
    # seeded weights (the JAX package's differ by design: an init
    # checkpoint is what carries weights across)
    model = HybridRNNTCTC(model_cfg, device=device)
    init_weights_(model, torch.Generator().manual_seed(cfg.seed))
    if cfg.get("init_checkpoint"):
        load_model(cfg.init_checkpoint, model)
    if mesh is not None:
        shard_model(model, mesh)  # the model axis; AdamW then holds the shards
    optimizer = make_optimizer(model, lr=cfg.lr,
                               freeze_encoder_till=cfg.model.freeze_encoder_till,
                               device=device)

    b = cfg.get("buckets", {})
    bucket_spec = BucketSpec(
        boundaries_sec=tuple(b.get("boundaries_sec", (4.0, 8.0, 12.0, 16.7))),
        max_tokens=tuple(b.get("max_tokens", (64, 128, 192, 256))),
    )
    step_cfg = StepConfig(
        frontend=FrontendConfig(n_mels=model_cfg.encoder.feat_in),
        spec_augment=SpecAugmentConfig(),
        ctc_loss_weight=cfg.model.get("ctc_loss_weight", 0.5),
        rnnt_chunk_size=cfg.get("rnnt_chunk_size", 32),
        use_spec_augment=cfg.get("use_spec_augment", True),
        # each CL task trains exactly one language; train/driver.py checks
        # on the host that every batch is one language
        uniform_lang_head=cfg.get("uniform_lang_head", True),
        rnnt_remat=cfg.get("rnnt_remat", "full"),
    )

    logger = Logger(cfg.output_dir, use_wandb=cfg.get("use_wandb", True),
                    wandb_kwargs={"notes": ns.notes, "config": cfg.to_dict()})
    logger.log({"config": cfg.to_dict(), "notes": ns.notes})
    # a self-contained run dir: the resolved config and the tokenizer next
    # to the checkpoints, so transcribe.py restores any run from it alone;
    # the run dir is shared by the process group: one writer
    if is_main_process():
        with open(os.path.join(logger.dir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=2, default=str)
        tokenizer.save(os.path.join(logger.dir, "tokenizer"))
    barrier("run dir")

    driver_cfg = DriverConfig(
        batch_size=cfg.batch_size,
        epochs=cfg.epochs,
        seed=cfg.seed,
        n_langs=cfg.n_langs,
        save_weights=cfg.get("save_weights", True),
        output_dir=cfg.output_dir,
        evaluate_every_n_epochs=cfg.cl_config.get("evaluate_every_n_epochs", 0),
        bucket_spec=bucket_spec,
    )
    checkpointer = SequenceCheckpointer(
        os.path.join(logger.dir, "sequence") if cfg.get("resume_dir") is None
        else cfg.resume_dir)
    return dict(
        cfg=cfg, languages=languages, task_data=task_data, tokenizer=tokenizer,
        model_cfg=model_cfg, model=model, optimizer=optimizer, step_cfg=step_cfg,
        logger=logger, driver_cfg=driver_cfg, checkpointer=checkpointer, device=device,
        mesh=mesh,
    )


def run(ctx: dict, method) -> dict:
    """``run_sequence`` over ``build_all``'s context with ``method``; closes
    the logger."""
    results = run_sequence(
        cfg=ctx["driver_cfg"], model=ctx["model"], step_cfg=ctx["step_cfg"],
        optimizer=ctx["optimizer"], method=method, task_data=ctx["task_data"],
        tokenizer=ctx["tokenizer"], logger=ctx["logger"],
        checkpointer=ctx["checkpointer"], languages=ctx["languages"],
        device=ctx["device"], mesh=ctx["mesh"],
    )
    ctx["logger"].close()
    return results
