"""The port's config parsing against the JAX package's: the same YAML and
argv give equal ``to_dict()`` from ``load_config`` +
``override_config_with_args`` (bool spellings, numbers, YAML ``null``
leaves, list leaves, nested paths, ``--notes``; an unknown flag exits in
both), the port's YAML copies load to the JAX package's dicts, and the
drivers' ``setup`` gives equal configs. Every comparison is exact."""

import os

import pytest

from indic_cl_asr_tpu.utils import config as JC
from indic_cl_asr_torch.scripts import _common as C
from indic_cl_asr_torch.utils import config as PC

ROOT = os.path.join(os.path.dirname(__file__), "..")
YAMLS = [
    (os.path.join(ROOT, "scripts", name), os.path.join(ROOT, "indic_cl_asr_torch", "scripts", name))
    for name in ("config.yaml", "finetune_config.yaml")
]
NOTES = {"notes": {"type": str, "default": ""}}

ARGV = {
    "none": [],
    "bools": ["--mixed_precision", "yes", "--use_wandb", "0", "--synthetic", "t",
              "--save_weights", "N", "--cl_config.faithful_raw_logits", "TRUE"],
    "numbers": ["--batch_size", "8", "--lr", "3e-4", "--model.n_layers", "4",
                "--cl_config.mas_ctx", "0.5", "--cl_config.e_lambda", "7"],
    "null_leaves": ["--init_checkpoint", "null", "--tokenizer_dir", "toks",
                    "--resume_dir", "3"],
    "lists": ["--buckets.boundaries_sec", "2.0", "5.5", "--buckets.max_tokens", "64", "96"],
    "empty_list": ["--buckets.max_tokens"],
    "nested": ["--model.d_model", "128", "--dataset.manifest_dir", "/m",
               "--mesh.data", "1", "--dataset.train_size", "10"],
    "notes": ["--notes", "a run", "--epochs", "3"],
}


def _both(yaml_pair, argv):
    jcfg, jns = JC.override_config_with_args(JC.load_config(yaml_pair[0]), list(argv),
                                            extra_args=NOTES)
    pcfg, pns = PC.override_config_with_args(PC.load_config(yaml_pair[1]), list(argv),
                                            extra_args=NOTES)
    return jcfg, jns, pcfg, pns


@pytest.mark.parametrize("yaml_pair", YAMLS, ids=["config", "finetune"])
@pytest.mark.parametrize("case", sorted(ARGV))
def test_overrides_parse_as_the_jax_package_parses_them(yaml_pair, case):
    jcfg, jns, pcfg, pns = _both(yaml_pair, ARGV[case])
    assert pcfg.to_dict() == jcfg.to_dict()
    assert pns.notes == jns.notes
    assert isinstance(pcfg, PC.ConfigDict)


def test_leaf_types_after_overrides():
    _, _, cfg, ns = _both(YAMLS[0], ARGV["bools"] + ARGV["null_leaves"] + ARGV["lists"]
                          + ARGV["notes"])
    assert cfg.mixed_precision is True and cfg.use_wandb is False and cfg.synthetic is True
    assert cfg.save_weights is False and cfg.cl_config.faithful_raw_logits is True
    assert cfg.init_checkpoint is None and cfg.resume_dir == 3
    assert cfg.tokenizer_dir == "toks"
    assert cfg.buckets.boundaries_sec == [2.0, 5.5] and cfg.buckets.max_tokens == [64, 96]
    assert cfg.epochs == 3 and ns.notes == "a run"


@pytest.mark.parametrize("argv", [["--no_such_flag", "1"], ["--batch_size", "eight"],
                                  ["--mixed_precision", "maybe"]],
                         ids=["unknown", "bad_int", "bad_bool"])
def test_bad_flags_exit_in_both_packages(argv):
    for pkg, path in ((JC, YAMLS[0][0]), (PC, YAMLS[0][1])):
        with pytest.raises(SystemExit):
            pkg.override_config_with_args(pkg.load_config(path), argv, extra_args=NOTES)


@pytest.mark.parametrize("s", ["true", "1", "yes", "y", "t", "false", "0", "no", "n", "f",
                               " Yes ", "T"])
def test_parse_bool_spellings(s):
    assert PC._parse_bool(s) == JC._parse_bool(s)


@pytest.mark.parametrize("yaml_pair", YAMLS, ids=["config", "finetune"])
def test_yaml_copies_load_to_the_jax_dicts(yaml_pair):
    j, p = JC.load_config(yaml_pair[0]), PC.load_config(yaml_pair[1])
    assert p.to_dict() == j.to_dict()
    assert list(p.leaves()) == list(j.leaves())


def test_driver_setup_matches_and_takes_a_device():
    import importlib
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    jcommon = importlib.import_module("_common")
    argv = ARGV["numbers"] + ARGV["notes"]
    jcfg, jns = jcommon.setup(list(argv), notes_default="ewc")
    pcfg, pns = C.setup(list(argv), notes_default="ewc")
    assert pcfg.to_dict() == jcfg.to_dict() and pns.notes == jns.notes
    assert pns.device == "cuda"  # an extra argument, not a config leaf
    pcfg, pns = C.setup(["--device", "cpu"])
    assert pns.device == "cpu" and "device" not in pcfg
    fcfg, _ = C.setup([], config_path=os.path.join(ROOT, "indic_cl_asr_torch", "scripts",
                                                  "finetune_config.yaml"))
    assert fcfg.languages == ["hindi", "tamil"]
