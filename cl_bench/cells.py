"""The two kinds of cell, driven through the port's own entry points.

``TrainCell``: the CL task's step loop as ``train/driver.py:run_sequence``
runs it (``BatchPipeline`` with shuffling, ``batch_to_device_dict``, the
method's ``make_train_step``, the aux values read as floats), epoch after
epoch over the mix's fixed set. The first of the set-up's warm-up epochs,
one step a bucket, is what the reference follows.

``EvalCell``: ``train/eval.py:run_eval`` over the mix's sets through one
``Transcriber`` (greedy RNNT and greedy CTC), pass after pass; every
decoded row of the last pass is recorded for the check.

Each cell first ``prepare``s what the benchmark makes (the traffic, the
weights and, for the eval cell, the blank calibration) and then ``setup``s
the program on it (the model, the step or transcriber, the warm-up passes);
only the latter is the set-up that ``setup_s`` times.

The program is imported inside the functions that drive it: the
reference and the readers never import it.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from . import traffic
from .check import MEDIAN_STEPS
from .reference.layout import is_trainable, make_weights
from .work import encoder_frames, mel_frames, padded_frames

# the CL config's language order: a language's head is its place here
LANGUAGES = ["hindi", "bengali", "marathi", "telugu", "tamil", "urdu",
             "gujarati", "kannada", "odia", "malayalam", "punjabi", "sanskrit"]


def span(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_parts(cfg: dict):
    """The port's configuration objects for a configuration file."""
    from indic_cl_asr_torch.audio.features import FrontendConfig
    from indic_cl_asr_torch.audio.spec_augment import SpecAugmentConfig
    from indic_cl_asr_torch.models.conformer import ConformerConfig
    from indic_cl_asr_torch.models.hybrid import HybridModelConfig
    from indic_cl_asr_torch.train.step import StepConfig

    m, tr = cfg["model"], cfg["train"]
    enc_keys = ("feat_in", "n_layers", "d_model", "n_heads", "ff_expansion_factor",
                "conv_kernel_size", "subsampling_factor", "subsampling_conv_channels",
                "dropout", "dropout_pre_encoder", "dropout_att", "xscale", "attn_impl",
                "frozen_till")
    hybrid = HybridModelConfig(
        encoder=ConformerConfig(**{k: m[k] for k in enc_keys}),
        vocab_size_total=m["vocab_size_total"], n_langs=m["n_langs"],
        pred_hidden=m["pred_hidden"], pred_rnn_layers=m["pred_rnn_layers"],
        pred_dropout=m["pred_dropout"], joint_hidden=m["joint_hidden"],
        joint_activation=m["joint_activation"], joint_dropout=m["joint_dropout"],
        dtype=getattr(torch, m["dtype"]))
    frontend = FrontendConfig(**cfg["frontend"])
    step_cfg = StepConfig(
        frontend=frontend, spec_augment=SpecAugmentConfig(**cfg["spec_augment"]),
        ctc_loss_weight=tr["ctc_loss_weight"], rnnt_chunk_size=tr["rnnt_chunk_size"],
        use_spec_augment=tr["use_spec_augment"], rnnt_impl=tr["rnnt_impl"],
        rnnt_remat=tr["rnnt_remat"], uniform_lang_head=tr["uniform_lang_head"])
    return hybrid, step_cfg, frontend


def tokenizer(languages):
    from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer

    return MultilingualTokenizer({lang: CharTokenizer(traffic.VOCAB) for lang in languages})


def bucket_spec(mix: dict):
    from indic_cl_asr_torch.data.pipeline import BucketSpec

    return BucketSpec(tuple(mix["bucket_boundaries_s"]), tuple(mix["bucket_max_tokens"]))


def entries(utts):
    from indic_cl_asr_torch.data.manifest import ManifestEntry

    return [ManifestEntry(audio_filepath=u.path, duration=u.seconds, text=u.text, lang=u.lang)
            for u in utts]


def p90(values) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


class Cell:
    """What both kinds share: the traffic on disk, the device, the check's
    records. ``workdir`` defaults to a fixed folder under TMPDIR."""

    def __init__(self, name: str, cfg: dict, mix: dict, seed: int, device, workdir=None):
        self.name, self.cfg, self.mix, self.seed = name, cfg, mix, seed
        self.m = cfg["model"]
        self.device = torch.device(device)
        self.workdir = workdir or os.path.join(tempfile.gettempdir(), "cl_bench", f"{name}-{seed}")
        self.tracing = False

    def make_traffic(self):
        shutil.rmtree(self.workdir, ignore_errors=True)
        self.utts = traffic.generate(self.mix, self.seed, self.workdir, self.device)
        self.by_samples = {u.samples: u for u in self.utts}

    def cleanup(self):
        shutil.rmtree(self.workdir, ignore_errors=True)

    def passes(self, seconds: float, one_pass, t_start: float) -> list[float]:
        """Whole passes until the next would end past ``seconds``; the
        seconds of each."""
        times = []
        while True:
            now = time.perf_counter()
            if times and (now - t_start) + times[-1] > seconds:
                return times
            one_pass()
            times.append(time.perf_counter() - now)


class TrainCell(Cell):
    WARMUP_EPOCHS = 2  # the first is the one the check follows

    def prepare(self):
        self.make_traffic()
        self.weights = make_weights(self.m, self.seed, self.device)

    def setup(self, step_wrapper=None):
        from indic_cl_asr_torch.cl.methods import NaiveMethod
        from indic_cl_asr_torch.data.pipeline import BatchPipeline
        from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC
        from indic_cl_asr_torch.train.state import make_optimizer
        from indic_cl_asr_torch.train.step import make_train_step

        tr, mix = self.cfg["train"], self.mix
        if mix["method"] != "naive":
            raise ValueError(f"method {mix['method']!r}: the harness drives naive")
        hybrid, step_cfg, _ = program_parts(self.cfg)
        model = HybridRNNTCTC(hybrid, device=self.device)
        model.load_state_dict(self.weights, strict=True)
        self.p0 = {k: v for k, v in self.weights.items()
                   if is_trainable(k, tr["freeze_encoder_till"])}
        self.weights = None
        opt = make_optimizer(model, lr=tr["lr"], weight_decay=tr["weight_decay"],
                             freeze_encoder_till=tr["freeze_encoder_till"], device=self.device)
        task = mix["task_index"]
        step = NaiveMethod().make_train_step(
            lambda pen: make_train_step(model, step_cfg, opt, pen, device=self.device), task)
        self.step = step_wrapper(step, opt) if step_wrapper else step
        self.model, self.opt = model, opt
        self.pipe = BatchPipeline(entries(self.utts), tokenizer(mix["languages"]), LANGUAGES,
                                  mix["batch_size"], spec=bucket_spec(mix), shuffle=True,
                                  seed=self.seed + task)
        self.root = torch.Generator().manual_seed(self.seed)
        self.check_steps, self.checking, self.log = [], True, None
        self.delta3 = None
        self.epoch()  # the check's: every bucket's shape once
        self.checking = False
        self.delta = self.change()
        self.delta3 = self.delta3 or self.delta
        self.p0 = None
        for _ in range(self.WARMUP_EPOCHS - 1):
            self.epoch()

    def epoch(self):
        """One pass of the run_sequence step loop over the set."""
        from indic_cl_asr_torch.train.step import batch_to_device_dict

        it = iter(self.pipe)
        t_prev = time.perf_counter()
        while True:
            with span(self.tracing, "cl_bench.data_wait"):
                t0 = time.perf_counter()
                batch = next(it, None)
                wait = time.perf_counter() - t0
            if batch is None:
                return
            seed = int(torch.randint(0, 2**62, (1,), generator=self.root))
            with span(self.tracing, "cl_bench.step"):
                aux = self.step(batch_to_device_dict(batch, self.device),
                                torch.Generator().manual_seed(seed))
            with span(self.tracing, "cl_bench.sync"):
                vals = {k: float(v) for k, v in aux.items()}
            t = time.perf_counter()
            self.after_step(batch, seed, vals, t - t_prev, wait)
            t_prev = t

    def after_step(self, batch, seed, vals, dt, wait):
        if self.checking:
            # a row's utterance is found by its sample count
            self.check_steps.append({"seed": seed, "samples": [int(n) for n in batch.audio_len],
                                     "loss": vals["train_loss"]})
            if len(self.check_steps) == 1:  # the first gradient: mu = (1 - b1)·g, b1 = 0.9
                self.g1 = {n: float((mu / 0.1).double().norm())
                           for n, mu in zip(self.opt.names, self.opt.mu)}
            if len(self.check_steps) == MEDIAN_STEPS:
                self.delta3 = self.change()
        if self.log is not None:
            real = float(batch.audio_len[:batch.n_real].sum()) / traffic.SAMPLE_RATE
            self.log.append({"dt": dt, "wait": wait, "audio_s": real, "loss": vals["train_loss"],
                             "shape": self.shape(batch)})

    def change(self) -> dict:
        """Each trainable leaf's norm of its change since the start."""
        return {n: float((p.detach() - self.p0[n]).double().norm())
                for n, p in zip(self.opt.names, self.opt.params)}

    def shape(self, batch) -> dict:
        S, U = batch.audio.shape[1], batch.tokens.shape[1]
        return {"B": batch.audio.shape[0], "S": S, "T": padded_frames(S, self.m), "U1": U + 1,
                "lens": [encoder_frames(mel_frames(int(n)), self.m) for n in batch.audio_len]}

    def window(self, seconds: float) -> dict:
        self.log = []
        sync(self.device)
        t0 = time.perf_counter()
        epochs = self.passes(seconds, self.epoch, t0)
        wall = time.perf_counter() - t0
        steps = self.log
        by_bucket = {}
        for s in steps:
            by_bucket.setdefault(s["shape"]["S"], []).append(1e3 * s["dt"])
        return {"window_s": wall, "attempted": len(steps),
                "failed": sum(not np.isfinite(s["loss"]) for s in steps),
                "metrics": {"train_audio_s_per_s": sum(s["audio_s"] for s in steps) / wall,
                            "train_step_ms_p90": 1e3 * p90([s["dt"] for s in steps])},
                "window": {"steps": len(steps), "seconds": wall, "epoch_s": epochs,
                           "audio_s": sum(s["audio_s"] for s in steps),
                           "step_ms_median_by_samples": {k: statistics.median(v)
                                                         for k, v in sorted(by_bucket.items())}}}

    def traced(self, epochs: int = 2):
        self.log = []
        self.tracing = True
        sync(self.device)
        t0 = time.perf_counter()
        for _ in range(epochs):
            self.epoch()
        sync(self.device)
        wall = time.perf_counter() - t0
        self.tracing = False
        steps = self.log
        return wall, {"kind": "train", "steps": [s["shape"] for s in steps],
                      "audio_s": sum(s["audio_s"] for s in steps),
                      "data_wait_s": [s["wait"] for s in steps],
                      "attempted": len(steps),
                      "failed": sum(not np.isfinite(s["loss"]) for s in steps)}

    def free(self):
        self.model = self.opt = self.step = self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_readings(self) -> dict:
        return {"losses": [s["loss"] for s in self.check_steps], "g1": self.g1,
                "delta3": self.delta3, "delta": self.delta}


class EvalCell(Cell):
    def prepare(self):
        from .calibrate import calibrate

        self.make_traffic()
        self.weights = make_weights(self.m, self.seed, self.device, serving=True)
        by_lang = {lang: [u for u in self.utts if u.lang == lang] for lang in self.mix["languages"]}
        self.biases = calibrate(self.cfg, self.mix, self.weights, by_lang, self.device)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def setup(self, decode_wrapper=None):
        from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC
        from indic_cl_asr_torch.train.eval import Transcriber

        mix, dec = self.mix, self.cfg["decode"]
        hybrid, _, frontend = program_parts(self.cfg)
        model = HybridRNNTCTC(hybrid, device=self.device)
        model.load_state_dict(self.weights, strict=True)
        self.weights = None
        tr = Transcriber(model=model, tokenizer=tokenizer(mix["languages"]), languages=LANGUAGES,
                         frontend=frontend, batch_size=mix["batch_size"],
                         bucket_spec=bucket_spec(mix), max_symbols=dec["max_symbols"],
                         max_out=dec["max_out"])
        decode = decode_wrapper(tr.decode_batch) if decode_wrapper else tr.decode_batch

        def recorded(audio, audio_len, lang_ids, decoder, n_real=None):
            with span(self.tracing, f"cl_bench.decode_{decoder}"):
                rows = decode(audio, audio_len, lang_ids, decoder, n_real)
            self.records.append((decoder, audio_len, rows))
            return rows

        tr.decode_batch = recorded
        self.tr, self.model = tr, model
        self.sets = {}
        for u, e in zip(self.utts, entries(self.utts)):
            self.sets.setdefault((u.lang, u.set), []).append(e)
        self.one_pass()  # every shape, both decoders

    def one_pass(self):
        from indic_cl_asr_torch.train.eval import run_eval

        self.records = []
        clean, noisy = self.mix["sets"]
        with span(self.tracing, "cl_bench.pass"):
            for i, lang in enumerate(self.mix["languages"]):
                run_eval(None, "val", self.tr, self.sets[(lang, clean)], self.sets[(lang, noisy)],
                         0, i, lang)

    def pass_audio_s(self) -> float:
        return 2 * sum(u.seconds for u in self.utts)  # RNNT and CTC

    def window(self, seconds: float) -> dict:
        sync(self.device)
        t0 = time.perf_counter()
        times = self.passes(seconds, self.one_pass, t0)
        n = len(times)
        wall = time.perf_counter() - t0
        return {"window_s": wall, "attempted": 2 * n * len(self.utts), "failed": 0,
                "metrics": {"eval_audio_s_per_s": n * self.pass_audio_s() / wall},
                "window": {"passes": n, "seconds": wall, "pass_s": times}}

    def traced(self):
        self.tracing = True
        sync(self.device)
        t0 = time.perf_counter()
        self.one_pass()
        sync(self.device)
        wall = time.perf_counter() - t0
        self.tracing = False
        batches = []
        for decoder, audio_len, rows in self.records:
            samples = audio_len.cpu().tolist()
            lens = [encoder_frames(mel_frames(n), self.m) for n in samples]
            emitted = [len(r) for r in rows]
            S = int(traffic.SAMPLE_RATE * self.mix["bucket_boundaries_s"][
                self.by_samples[samples[0]].bucket])
            batches.append({"decoder": decoder, "B": len(samples), "S": S,
                            "T": padded_frames(S, self.m), "lens": lens, "emitted": emitted,
                            "joint_evals": sum(lens) + sum(emitted),
                            "lstm_steps": len(samples) + sum(emitted)})
        return wall, {"kind": "eval", "batches": batches, "attempted": 2 * len(self.utts),
                      "failed": 0}

    def free(self):
        self.answers = self.collect()
        self.tr = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def collect(self) -> dict:
        """{(decoder, samples): token ids} of the last pass."""
        out = {}
        for decoder, audio_len, rows in self.records:
            for n, ids in zip(audio_len.cpu().tolist(), rows):
                out.setdefault((decoder, n), []).append(list(ids))
        return out
