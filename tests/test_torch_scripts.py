"""The port's command line (indic_cl_asr_torch/scripts) against the JAX
package's scripts/, on the CPU in f32 at tiny widths (2 layers, d_model
64, ``--model.attn_impl xla``, ``--device cpu``). Every comparison is
exact:

  * data and model config: ``make_wav_dataset`` writes byte-equal WAVs;
    ``build_data`` gives equal entries over a manifest dir, a pickled
    annotation and ``--synthetic true``; ``build_tokenizer`` equal
    vocabularies and ids; ``build_model_cfg`` equal fields; ``build_all``
    the JAX trainable mask (mapped through models/convert.py), AdamW
    hyperparameters, StepConfig, BucketSpec and DriverConfig (the causal
    conv and Longformer options included); a mesh beyond the process
    group (either axis) and a multi-process launch without its rendezvous
    raise ``ValueError``;
  * checkpoints: JAX partial saves in both encoder layouts (one without
    the frozen layers) through ``load_partial``, the port's own saves
    round-tripped, an unknown name raising;
  * the CLI against the JAX CLI: ``cl_baseline.main --epochs 0`` in both
    packages from the same init weights (an orbax tree for the JAX
    package, an ``.npz`` of its named leaves for the port) logs equal
    val/test WER records and BWT curves, each ``transcribe.main --run``
    prints the same texts, and the JAX run's scan-layout
    ``model_hindi.npz`` loads into the port;
  * every driver (one step a task on two synthetic languages) writes the
    JAX run dir's files; ``--resume_dir`` logs ``resumed_from_task``;
  * the results report and the data-prep scripts: equal summaries, scores,
    perf matrices, PDF names, manifests, annotation dicts and vocabularies.
"""

import dataclasses
import importlib
import inspect
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.analysis import results as JR
from indic_cl_asr_tpu.data.manifest import write_manifest as j_write_manifest
from indic_cl_asr_tpu.models.hybrid import init_model
from indic_cl_asr_tpu.train import state as JS
from indic_cl_asr_tpu.utils.checkpoint import save_partial as j_save_partial
from indic_cl_asr_tpu.utils.checkpoint import save_pytree
from indic_cl_asr_tpu.utils.pytree import conformer_freeze_mask, named_leaves
from indic_cl_asr_torch.analysis import results as PR
from indic_cl_asr_torch.data import synth as psynth
from indic_cl_asr_torch.models.convert import from_jax_variables, named_state_dict
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, init_weights_
from indic_cl_asr_torch.scripts import _common as C
from indic_cl_asr_torch.scripts import cl_baseline, cl_ewc, cl_lwf, cl_mas, finetune
from indic_cl_asr_torch.scripts import dataset_gen as p_dataset_gen
from indic_cl_asr_torch.scripts import results as p_results
from indic_cl_asr_torch.scripts import train_tokenizer as p_train_tokenizer
from indic_cl_asr_torch.scripts import transcribe as p_transcribe
from indic_cl_asr_torch.train import state as PS
from indic_cl_asr_torch.utils.checkpoint import (
    load_model,
    load_partial,
    save_model,
    save_partial,
)

from . import synth as jsynth
from .test_scripts import make_raw_tree

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
J = importlib.import_module("_common")  # the JAX package's scripts/_common.py
j_cl_baseline = importlib.import_module("cl_baseline")
j_dataset_gen = importlib.import_module("dataset_gen")
j_train_tokenizer = importlib.import_module("train_tokenizer")
j_transcribe = importlib.import_module("transcribe")

TINY = ["--n_langs", "2", "--batch_size", "4", "--synthetic_utts", "4", "--use_wandb",
        "false", "--model.n_layers", "2", "--model.d_model", "64", "--model.n_heads", "4",
        "--model.n_mels", "32", "--model.pred_hidden", "32", "--model.joint_hidden", "32",
        "--model.freeze_encoder_till", "1", "--mixed_precision", "false", "--rnnt_chunk_size",
        "8", "--buckets.boundaries_sec", "2.0", "--buckets.max_tokens", "64"]
XLA = ["--model.attn_impl", "xla"]  # a key of config.yaml, not of finetune_config.yaml
RUN_FILES = {"bwt_curves.json", "config.json", "log.txt", "metrics.jsonl", "sequence",
             "tokenizer"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CLI runs thousands of tiny ops; on a loaded CPU (the test tier's
    parallel workers) torch's intra-op threads wait on each other at every
    one: a tiny driver run took 55 s with 8 threads and 1.9 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_dir(out):
    (run,) = [os.path.join(out, d) for d in os.listdir(out)
              if os.path.exists(os.path.join(out, d, "config.json"))]
    return run


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != "_time"} for r in recs
            if any(k.startswith(("val/", "test/")) for k in r)]


def _entry_key(e, root):
    return (e.text, e.duration, e.lang, os.path.relpath(e.audio_filepath, root))


# ---------------------------------------------------------------------------
# data, tokenizer and model config
# ---------------------------------------------------------------------------

def test_make_wav_dataset_writes_the_same_bytes(tmp_path):
    a = jsynth.make_wav_dataset(str(tmp_path / "j"), ["hindi", "tamil"], n_per_lang=3, seed=4)
    b = psynth.make_wav_dataset(str(tmp_path / "p"), ["hindi", "tamil"], n_per_lang=3, seed=4)
    for lang in a:
        assert [_entry_key(e, tmp_path / "j") for e in a[lang]] == \
            [_entry_key(e, tmp_path / "p") for e in b[lang]]
        for e in a[lang]:
            name = os.path.basename(e.audio_filepath)
            assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "p" / name).read_bytes()
    assert jsynth.make_texts("bengali", 7, seed=2) == psynth.make_texts("bengali", 7, seed=2)


def _setups(argv, jdir, pdir, config=None):
    jcfg, jns = J.setup(list(argv) + ["--output_dir", str(jdir)],
                        config_path=config and os.path.join(ROOT, "scripts", config))
    pcfg, pns = C.setup(list(argv) + ["--output_dir", str(pdir)],
                        config_path=config and os.path.join(ROOT, "indic_cl_asr_torch",
                                                            "scripts", config))
    return jcfg, jns, pcfg, pns


def test_build_data_and_tokenizer_match(tmp_path):
    langs = ["hindi", "bengali"]
    # a manifest dir
    data = jsynth.make_wav_dataset(str(tmp_path / "wavs"), langs, n_per_lang=10)
    mdir = tmp_path / "manifests"
    mdir.mkdir()
    for lang, es in data.items():
        for i, split in enumerate(("train", "val", "noisy_val", "test", "noisy_test")):
            j_write_manifest(str(mdir / f"{lang}_{split}.jsonl"), es[2 * i : 2 * i + 2])
    # a pickled annotation over a raw tree
    raw = str(tmp_path / "raw")
    make_raw_tree(raw, langs)
    with open(tmp_path / "ann.pkl", "wb") as f:
        pickle.dump(j_dataset_gen.build(raw, langs), f)
    for argv in (["--dataset.manifest_dir", str(mdir), "--dataset.train_size", "1"],
                 ["--dataset.annotation_path", str(tmp_path / "ann.pkl"), "--dataset.path", raw],
                 ["--synthetic", "true", "--synthetic_utts", "4"]):
        jcfg, _, pcfg, _ = _setups(["--n_langs", "2"] + argv, tmp_path / "j", tmp_path / "p")
        jd = J.build_data(jcfg, J.build_languages(jcfg))
        pd = C.build_data(pcfg, C.build_languages(pcfg))
        assert list(jd) == list(pd) == langs
        for lang in langs:
            for field in ("train", "val_clean", "val_noisy", "test_clean", "test_noisy"):
                got = [_entry_key(e, tmp_path / "p") for e in getattr(pd[lang], field)]
                want = [_entry_key(e, tmp_path / "j") for e in getattr(jd[lang], field)]
                assert got == want and (got or field != "train"), (argv, lang, field)
        jt, pt = J.build_tokenizer(jcfg, langs, jd), C.build_tokenizer(pcfg, langs, pd)
        assert pt.vocab == jt.vocab and pt.vocab_size == jt.vocab_size
        for lang in langs:
            text = jd[lang].train[0].text
            assert pt.text_to_ids(text, lang) == jt.text_to_ids(text, lang)


def _dtype_name(d):
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) else jax.numpy.dtype(d).name


def _same_fields(port_cfg, jax_cfg):
    for f in dataclasses.fields(port_cfg):
        p, j = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(p):
            _same_fields(p, j)
        elif f.name == "dtype":
            assert _dtype_name(p) == _dtype_name(j), f.name
        else:
            assert p == j, (f.name, p, j)


class _Vocab:
    vocab_size = 2 * 40


@pytest.mark.parametrize("argv,config", [
    ([], None),
    (["--mixed_precision", "false", "--model.attn_impl", "xla", "--model.n_layers", "4",
      "--model.att_context_left", "16", "--model.att_context_right", "0", "--n_langs", "2",
      "--model.freeze_encoder_till", "2", "--model.scan_layers", "false"], None),
    ([], "finetune_config.yaml"),
    (["--model.causal_conv", "true", "--model.att_context_left", "70",
      "--model.att_context_right", "0"], None),
    (["--model.global_tokens", "4", "--model.global_tokens_spacing", "8",
      "--model.global_attn_separate", "true"], None),
], ids=["config", "overrides", "finetune_no_attn_impl", "causal_conv", "global_tokens"])
def test_build_model_cfg_matches(tmp_path, argv, config):
    jcfg, _, pcfg, _ = _setups(argv, tmp_path / "j", tmp_path / "p", config)
    langs = J.build_languages(jcfg)
    assert C.build_languages(pcfg) == langs
    jm = J.build_model_cfg(jcfg, _Vocab(), langs)
    pm = C.build_model_cfg(pcfg, _Vocab(), langs)
    _same_fields(pm, jm)
    assert pm.n_langs == len(langs) and pm.encoder.attn_impl == jm.encoder.attn_impl
    if config:
        assert pm.encoder.attn_impl == "xla"


@pytest.mark.parametrize("argv,env,error", [
    (["--mesh.data", "2"], None, ValueError), (["--mesh.model", "2"], None, ValueError),
    (["--mesh.data", "0", "--mesh.model", "2"], None, ValueError),
    ([], "1", ValueError),
], ids=["mesh_data", "mesh_model", "mesh_all_devices", "multihost"])
def test_what_the_port_lacks_raises(tmp_path, monkeypatch, argv, env, error):
    """A mesh larger than the process group (a data or a model axis of 2,
    or every process over a model axis of 2, at one process), and
    INDIC_ASR_MULTIHOST=1 with neither a coordinator nor torchrun's
    variables, are refused (tests/test_torch_distributed.py runs the data
    axis, tests/test_torch_tensor_parallel.py the model axis)."""
    if env:
        monkeypatch.setenv("INDIC_ASR_MULTIHOST", env)
        for var in ("INDIC_ASR_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
    with pytest.raises(error):
        cl_baseline.main(TINY + XLA + argv + ["--synthetic", "true", "--device", "cpu",
                                              "--output_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``build_all`` of both packages, and ``cl_baseline.main --epochs 0`` of
    both from the JAX ``build_all``'s initial variables."""
    root = tmp_path_factory.mktemp("cli")
    argv = TINY + XLA + ["--synthetic", "true", "--epochs", "0", "--notes", "t"]
    jcfg, jns, pcfg, pns = _setups(argv + ["--lr", "3e-4"], root / "jax_ctx", root / "port_ctx")
    pns.device = "cpu"
    jctx, pctx = J.build_all(jcfg, jns), C.build_all(pcfg, pns)
    for ctx in (jctx, pctx):
        ctx["logger"].close()
    state = jctx["state"]
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    save_pytree(str(root / "init_orbax"), variables)
    np.savez(root / "init.npz", **named_leaves(variables))
    j_res = j_cl_baseline.main(argv + ["--output_dir", str(root / "jax"),
                                       "--init_checkpoint", str(root / "init_orbax")])
    p_res = cl_baseline.main(argv + ["--output_dir", str(root / "port"), "--device", "cpu",
                                     "--init_checkpoint", str(root / "init.npz")])
    return dict(root=root, variables=variables, langs=J.build_languages(jcfg), jax_res=j_res,
                port_res=p_res, jax_run=_run_dir(root / "jax"), port_run=_run_dir(root / "port"),
                jctx=jctx, pctx=pctx)


def test_build_all_matches(cli_runs):
    """The trainable set is the JAX mask (the scanned stack's rows below
    freeze_encoder_till frozen, as row_sliced_stacked freezes them), and the
    optimizer's, step's, buckets' and driver's settings are the JAX ones."""
    jctx, pctx = cli_runs["jctx"], cli_runs["pctx"]
    jcfg, pcfg = jctx["cfg"], pctx["cfg"]
    named = named_leaves(jctx["state"].params)
    mask = named_leaves(jctx["mask"])
    assert any("/stack/layers/" in k for k in named)
    F = jcfg.model.freeze_encoder_till
    trainable = {n for n in named_state_dict({k: v for k, v in named.items() if mask[k]})
                 if not (n.startswith("encoder.layers.") and int(n.split(".")[2]) < F)}
    opt = pctx["optimizer"]
    assert set(opt.names) == trainable and "encoder.layers.1.norm_out.weight" in trainable
    wd = inspect.signature(JS.make_optimizer).parameters["weight_decay"].default
    assert (opt.lr, opt.weight_decay, opt.grad_clip) == (jcfg.lr, wd, None) == (3e-4, 0.01, None)
    assert (PS.B1, PS.B2, PS.EPS) == (0.9, 0.999, 1e-8)
    _same_fields(pctx["step_cfg"], jctx["step_cfg"])
    _same_fields(pctx["model_cfg"], jctx["model_cfg"])
    assert pctx["step_cfg"].ctc_loss_weight == jctx["model_cfg"].ctc_loss_weight
    pd, jd = dataclasses.asdict(pctx["driver_cfg"]), dataclasses.asdict(jctx["driver_cfg"])
    assert (pd.pop("output_dir"), jd.pop("output_dir")) == (pcfg.output_dir, jcfg.output_dir)
    assert pd == jd and pd["bucket_spec"]["boundaries_sec"] == (2.0,)
    with open(os.path.join(jctx["logger"].dir, "config.json")) as a, \
            open(os.path.join(pctx["logger"].dir, "config.json")) as b:
        ja, pb = json.load(a), json.load(b)
    assert ja.pop("output_dir") != pb.pop("output_dir") and pb == ja
    assert pctx["tokenizer"].vocab == jctx["tokenizer"].vocab


def test_cli_logs_the_jax_records(cli_runs):
    jrun, prun = cli_runs["jax_run"], cli_runs["port_run"]
    assert _records(prun) == _records(jrun)
    assert len(_records(prun)) == 6  # val and test after each task: 1 + 2 languages
    with open(os.path.join(jrun, "bwt_curves.json")) as a, \
            open(os.path.join(prun, "bwt_curves.json")) as b:
        assert json.load(b) == json.load(a)
    assert cli_runs["port_res"] == cli_runs["jax_res"]
    assert set(os.listdir(jrun)) == RUN_FILES | {f"model_{l}.npz" for l in cli_runs["langs"]}


@pytest.mark.parametrize("decoder", ["rnnt", "ctc"])
def test_transcribe_prints_the_jax_texts(cli_runs, capsys, decoder):
    manifest = os.path.join(cli_runs["root"], "jax", "synthetic_data", "hindi.jsonl")
    args = ["--manifest", manifest, "--batch_size", "4", "--decoder", decoder, "--wer"]
    j_hyps = j_transcribe.main(["--run", cli_runs["jax_run"], *args])
    j_out = capsys.readouterr().out.splitlines()
    p_hyps = p_transcribe.main(["--run", cli_runs["port_run"], *args, "--device", "cpu"])
    p_out = capsys.readouterr().out.splitlines()
    assert p_hyps == j_hyps and len(p_hyps) == 12
    assert p_out == j_out  # the same manifest: paths, texts, refs and the WER line


def test_transcribe_rejects_nemo(tmp_path):
    """--nemo restores a .nemo (tests/test_torch_pretrained.py); a path
    that holds none is rejected before any audio is read."""
    with pytest.raises(FileNotFoundError):
        p_transcribe.main(["--nemo", str(tmp_path / "model.nemo"), "x.wav", "--device", "cpu"])


# ---------------------------------------------------------------------------
# checkpoints (on the CLI fixture's JAX variables, scanned stack, and the
# same variables unrolled)
# ---------------------------------------------------------------------------

def _variables(cli_runs, scan: bool):
    """Writable copies of the CLI's JAX init variables, in either layout."""
    out = jax.tree.map(np.array, cli_runs["variables"])
    if not scan:
        for coll in out.values():
            stack = coll["encoder"].pop("stack")["layers"]
            for i in range(jax.tree.leaves(stack)[0].shape[0]):
                coll["encoder"][f"layers_{i}"] = jax.tree.map(lambda x, i=i: x[i], stack)
    return out


def _port_model(cli_runs, seed=0):
    model = HybridRNNTCTC(cli_runs["pctx"]["model_cfg"], device="cpu")
    return init_weights_(model, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("scan,freeze", [(False, 0), (False, 1), (True, 1)],
                         ids=["unrolled", "unrolled_without_frozen", "scan"])
def test_load_partial_reads_jax_partial_saves(cli_runs, tmp_path, scan, freeze):
    variables = _variables(cli_runs, scan)
    path = str(tmp_path / "model_hindi.npz")
    j_save_partial(path, variables["params"],
                   conformer_freeze_mask(variables["params"], freeze))
    model = _port_model(cli_runs)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_partial(path, model)
    want = from_jax_variables(_port_model(cli_runs), variables).state_dict()
    with np.load(path) as saved:
        loaded = set(named_state_dict({k: saved[k] for k in saved.files}))
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name] if name in loaded else before[name]), name
    if freeze:  # the frozen prefix: no pre_encode; layer 0 only as a row of the stack
        assert not any(n.startswith("encoder.pre_encode.") for n in loaded)
        assert any(n.startswith("encoder.layers.0.") for n in loaded) == scan
    assert not any(n.endswith("running_mean") for n in loaded)


def test_port_saves_round_trip_and_unknown_names_raise(cli_runs, tmp_path):
    src, dst = _port_model(cli_runs, 0), _port_model(cli_runs, 1)
    names = PS.trainable_names(src, 1)
    save_partial(str(tmp_path / "p.npz"), src, names)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    load_partial(str(tmp_path / "p.npz"), dst)
    for name, value in dst.state_dict().items():
        assert torch.equal(value, src.state_dict()[name] if name in names else before[name])
    src.encoder.layers[0].conv.batch_norm.running_mean.fill_(0.25)
    save_model(str(tmp_path / "m.pt"), src)
    load_model(str(tmp_path / "m.pt"), dst)
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in dst.state_dict().items())
    # a whole JAX tree's named leaves, BatchNorm statistics included
    variables = _variables(cli_runs, True)
    variables["batch_stats"]["encoder"]["stack"]["layers"]["conv"]["batch_norm"]["mean"] += 0.5
    np.savez(tmp_path / "whole.npz", **named_leaves(variables))
    load_model(str(tmp_path / "whole.npz"), dst)
    want = from_jax_variables(_port_model(cli_runs), variables).state_dict()
    assert all(torch.equal(v, want[k]) for k, v in dst.state_dict().items())
    for bad in ({"encoder/layers_9/norm_out/scale": np.ones(64, np.float32)},
                {"joint.no_such": np.ones(3, np.float32)}):
        np.savez(tmp_path / "bad.npz", **bad)
        with pytest.raises(KeyError):
            load_partial(str(tmp_path / "bad.npz"), dst)
    with pytest.raises(ValueError):
        load_model(str(tmp_path), dst)


def test_load_partial_reads_the_jax_runs_save(cli_runs):
    path = os.path.join(cli_runs["jax_run"], "model_hindi.npz")
    with np.load(path) as saved:
        assert any("/stack/layers/" in k for k in saved.files)
        loaded = set(named_state_dict({k: saved[k] for k in saved.files}))
    model = _port_model(cli_runs, 5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_partial(path, model)
    want = from_jax_variables(_port_model(cli_runs), cli_runs["variables"]).state_dict()
    assert "encoder.layers.0.norm_out.weight" in loaded  # the stack's frozen row
    assert not any(n.startswith("encoder.pre_encode.") for n in loaded)
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name] if name in loaded else before[name]), name


# ---------------------------------------------------------------------------
# every driver, resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", [cl_baseline, cl_ewc, cl_mas, cl_lwf, finetune],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_driver_writes_the_run_dir(tmp_path, driver):
    argv = TINY + (XLA if driver is not finetune else []) + [
        "--synthetic", "true", "--epochs", "1", "--device", "cpu", "--output_dir",
        str(tmp_path)]
    res = driver.main(argv)
    run = _run_dir(tmp_path)
    langs = list(res["val"])
    assert langs == (["hindi", "tamil"] if driver is finetune else ["hindi", "bengali"])
    assert set(os.listdir(run)) == RUN_FILES | {f"model_{l}.npz" for l in langs}
    seq = set(os.listdir(os.path.join(run, "sequence")))
    tasks = {f"task_{i}_{l}.pt" for i, l in enumerate(langs)}
    method = {f"task_{i}_{l}_method.pt" for i, l in enumerate(langs)}
    assert seq == {"sequence.json"} | tasks | (set() if driver in (cl_baseline, finetune)
                                               else method)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if any(k.startswith("train/train_loss_") for k in r)]
    assert len(steps) == 2 and all(np.isfinite(v) for r in res["val"].values()
                                   for rec in r for v in rec.values())


def test_resume_dir_logs_the_resumed_task(tmp_path):
    argv = TINY + XLA + ["--synthetic", "true", "--epochs", "1", "--device", "cpu"]
    first = cl_baseline.main(argv + ["--output_dir", str(tmp_path / "a")])
    seq = os.path.join(_run_dir(tmp_path / "a"), "sequence")
    again = cl_baseline.main(argv + ["--output_dir", str(tmp_path / "b"), "--resume_dir", seq])
    assert again["val"] == first["val"]
    with open(os.path.join(_run_dir(tmp_path / "b"), "metrics.jsonl")) as f:
        resumed = [r for r in map(json.loads, f) if "resumed_from_task" in r]
    assert [(r["resumed_from_task"], r["resumed_lang"]) for r in resumed] == [(1, "bengali")]


# ---------------------------------------------------------------------------
# the results report and the data-prep scripts
# ---------------------------------------------------------------------------

def _three_task_records():
    rng = np.random.default_rng(3)
    langs = ["hindi", "bengali", "marathi"]
    recs = []
    for t in range(3):
        for split in ("val", "test"):
            for lang in langs[: t + 1]:
                rec = {"lang": t, "epoch": 0}
                for dec in ("rnnt", "ctc"):
                    w, n = rng.uniform(0.2, 1.0, 2)
                    rec.update({f"{split}/perf_{lang}_{dec}_wer": w,
                                f"{split}/perf_{lang}_{dec}_noisy_wer": n,
                                f"{split}/perf_{lang}_{dec}_avg_wer": (w + n) / 2})
                recs.append(rec)
    return recs


def test_results_report_matches(tmp_path, cli_runs):
    runs = {"three": tmp_path / "three", "cli": cli_runs["port_run"]}
    os.makedirs(runs["three"])
    with open(runs["three"] / "metrics.jsonl", "w") as f:
        for r in _three_task_records():
            f.write(json.dumps(r) + "\n")
    for d in runs.values():
        recs = PR.load_run_metrics(os.path.join(d, "metrics.jsonl"))
        assert recs == JR.load_run_metrics(os.path.join(d, "metrics.jsonl"))
        assert json.dumps(PR.summarize_run(recs)) == json.dumps(JR.summarize_run(recs))
        for dec in ("rnnt", "ctc"):
            for kind in ("wer", "noisy_wer", "avg_wer"):
                perf = PR.collect_perf(recs, "val", dec, kind)
                assert perf == JR.collect_perf(recs, "val", dec, kind)
                pm, pl = PR.perf_matrix(perf, PR.LANGUAGES)
                jm, jl = JR.perf_matrix(perf, JR.LANGUAGES)
                assert pl == jl and np.array_equal(pm, jm, equal_nan=True)
    named = {k: PR.load_run_metrics(os.path.join(d, "metrics.jsonl")) for k, d in runs.items()}
    for dec in ("rnnt", "ctc"):
        for metric in ("avg", "", "noisy"):
            assert PR.calc_scores(named, dec, metric) == JR.calc_scores(named, dec, metric)
    argv = [f"{k}={d}" for k, d in runs.items()] + ["--family", "mine=thr,cl"]
    p_sum = p_results.main(argv + ["--out", str(tmp_path / "p")])
    j_sum = JR.generate_report({k: str(d) for k, d in runs.items()}, str(tmp_path / "j"),
                               families={"mine": ["thr", "cl"]})
    assert json.dumps(p_sum) == json.dumps(j_sum)

    def pdfs(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                      for f in fs if f.endswith(".pdf"))

    assert pdfs(tmp_path / "p") == pdfs(tmp_path / "j") and len(pdfs(tmp_path / "p")) == 26
    assert all((tmp_path / "p" / f).read_bytes().startswith(b"%PDF-") for f in
               pdfs(tmp_path / "p"))


def test_dataset_gen_and_train_tokenizer_match(tmp_path):
    langs = ["hindi", "tamil"]
    raw = str(tmp_path / "raw")
    make_raw_tree(raw, langs)
    out = {}
    for name, gen, train in (("j", j_dataset_gen, j_train_tokenizer),
                             ("p", p_dataset_gen, p_train_tokenizer)):
        d = tmp_path / name
        d.mkdir()
        ann = gen.main(["--root", raw, "--out", str(d / "ann.pkl"), "--manifest_dir",
                        str(d / "m"), "--languages", *langs])
        with open(d / "ann.pkl", "rb") as f:
            assert pickle.load(f) == ann
        manifests = {f: (d / "m" / f).read_text() for f in sorted(os.listdir(d / "m"))}
        toks = [train.main(["--manifest_dir", str(d / "m"), "--out", str(d / f"tok_{kind}"),
                            "--vocab_size", "48", "--kind", kind, "--languages", *langs])
                for kind in ("bpe", "char")]
        out[name] = (ann, manifests, [(t.vocab, t.vocab_size) for t in toks])
    assert out["p"] == out["j"]
    assert len(out["p"][1]) == 10 and out["p"][2][0][1] == 96
