"""One-call ingestion of a ``.nemo`` checkpoint (config + weights +
tokenizers) into the port, plus an optional HuggingFace download.

Port of indic_cl_asr_tpu/models/nemo_ingest.py. The reference starts every
experiment from
``ASRModel.from_pretrained("ai4bharat/indicconformer_stt_hi_hybrid_rnnt_large")``
(cl_baseline.py:122), which downloads a ``.nemo`` tar and restores it
through SaveRestoreConnector. A ``.nemo`` tar holds:

  model_config.yaml      - the Hydra config the modules were built from
  model_weights.ckpt     - a torch state dict
  <hash>_tokenizer.model - per-language SentencePiece models, named in the
                           config as ``nemo:<hash>_tokenizer.model`` under
                           tokenizer.langs.<lang>.model_path

``model_config_from_nemo`` maps the config onto HybridModelConfig (f32 by
default), models/pretrained.py the weights onto the port's modules, and
``build_tokenizer_from_nemo`` the tokenizer artifacts onto a
MultilingualTokenizer over the pure-Python SentencePiece reader
(data/spm_model.py). ``restore_pretrained`` does all three on a device.

Kept from the JAX package: the encoder's ``xscale`` is read from the
config key ``xscale`` (NeMo names it ``xscaling``, so a real config keeps
the default, true); the heads come in ``pretrained.LANGUAGE_KEYS``' fixed
order, the tokenizer's languages in the config's order.
"""

from __future__ import annotations

import os
import tarfile
import time

import torch

from .conformer import ConformerConfig
from .convert import from_jax_variables
from .hybrid import HybridModelConfig, HybridRNNTCTC
from .pretrained import load_pretrained


def read_nemo_config(nemo_path: str) -> dict:
    """model_config.yaml from the .nemo tar -> a plain dict."""
    import yaml

    with tarfile.open(nemo_path) as tar:
        names = [m.name for m in tar.getmembers() if m.name.endswith("model_config.yaml")]
        if not names:
            raise FileNotFoundError(f"no model_config.yaml inside {nemo_path}")
        return yaml.safe_load(tar.extractfile(names[0]).read())


def model_config_from_nemo(cfg: dict, dtype: torch.dtype | None = None) -> HybridModelConfig:
    """The .nemo's Hydra config -> HybridModelConfig, field by field as the
    JAX package maps it: encoder.* (conformer_hybrid_transducer_ctc_bpe.yaml
    §encoder), the prediction and joint widths and the joint activation,
    and the aggregate vocab, the CTC head's num_classes (real tokens; the
    blank is added on top). Attention takes the CUDA flash route (the JAX
    mapping leaves its default, its XLA path)."""
    enc = cfg["encoder"]
    langs = list(cfg.get("tokenizer", {}).get("langs", {}) or {})
    n_langs = len(langs) or 12
    vocab_total = (
        cfg.get("aux_ctc", {}).get("decoder", {}).get("num_classes")
        or cfg.get("ctc_decoder", {}).get("num_classes")
        or cfg.get("decoder", {}).get("vocab_size")
    )
    if not vocab_total or vocab_total <= 0:
        per_lang = cfg.get("joint", {}).get("num_classes", 256)
        if not per_lang or per_lang <= 0:  # the -1 placeholder of saved configs
            per_lang = 256
        vocab_total = per_lang * n_langs
    dtype = dtype if dtype is not None else torch.float32
    encoder = ConformerConfig(
        feat_in=enc.get("feat_in", 80),
        n_layers=enc.get("n_layers", 17),
        d_model=enc.get("d_model", 512),
        n_heads=enc.get("n_heads", 8),
        ff_expansion_factor=enc.get("ff_expansion_factor", 4),
        conv_kernel_size=enc.get("conv_kernel_size", 31),
        conv_norm_type=enc.get("conv_norm_type", "batch_norm"),
        subsampling_factor=enc.get("subsampling_factor", 4),
        subsampling_conv_channels=enc.get("subsampling_conv_channels", -1) or -1,
        dropout=enc.get("dropout", 0.1),
        dropout_pre_encoder=enc.get("dropout_pre_encoder", 0.1),
        dropout_emb=enc.get("dropout_emb", 0.0),
        dropout_att=enc.get("dropout_att", 0.1),
        xscale=bool(enc.get("xscale", True)),
        pos_emb_max_len=enc.get("pos_emb_max_len", 5000),
        attn_impl="flash",
        dtype=dtype,
    )
    dec = cfg.get("decoder", {})
    prednet = dec.get("prednet", {}) if isinstance(dec, dict) else {}
    joint = cfg.get("joint", {})
    jointnet = joint.get("jointnet", {}) if isinstance(joint, dict) else {}
    return HybridModelConfig(
        encoder=encoder,
        vocab_size_total=int(vocab_total),
        n_langs=n_langs,
        pred_hidden=prednet.get("pred_hidden", 640),
        pred_rnn_layers=prednet.get("pred_rnn_layers", 1),
        joint_hidden=jointnet.get("joint_hidden", 640),
        joint_activation=jointnet.get("activation", "relu"),
        dtype=dtype,
    )


def extract_tokenizer_models(nemo_path: str, out_dir: str,
                             cfg: dict | None = None) -> dict[str, str]:
    """Each language's SentencePiece .model out of the tar -> {lang: path},
    in the config's language order. ``cfg`` saves a second scan of the tar
    when the caller has parsed the config already."""
    cfg = cfg if cfg is not None else read_nemo_config(nemo_path)
    langs_cfg = cfg.get("tokenizer", {}).get("langs", {}) or {}
    os.makedirs(out_dir, exist_ok=True)
    out: dict[str, str] = {}
    with tarfile.open(nemo_path) as tar:
        members = {os.path.basename(m.name): m for m in tar.getmembers()}
        for lang, tcfg in langs_cfg.items():
            ref = tcfg.get("model_path") or os.path.join(tcfg.get("dir", ""), "tokenizer.model")
            m = members.get(os.path.basename(ref.removeprefix("nemo:")))
            if m is None:
                # older checkpoints: artifacts under <lang>/tokenizer.model
                cands = [mm for name, mm in members.items()
                         if name.endswith("tokenizer.model") and f"/{lang}/" in mm.name]
                m = cands[0] if cands else None
            if m is None:
                raise FileNotFoundError(f"tokenizer model for {lang!r} ({ref!r}) not in the tar")
            dst = os.path.join(out_dir, f"{lang}_tokenizer.model")
            with tar.extractfile(m) as src, open(dst, "wb") as w:
                w.write(src.read())
            out[lang] = dst
    return out


def build_tokenizer_from_nemo(nemo_path: str, work_dir: str, cfg: dict | None = None):
    """A MultilingualTokenizer over the checkpoint's SentencePiece models,
    read by the pure-Python ModelProto reader (no sentencepiece library)."""
    from ..data.tokenizer import MultilingualTokenizer, SentencePieceTokenizer

    paths = extract_tokenizer_models(nemo_path, work_dir, cfg=cfg)
    return MultilingualTokenizer({lang: SentencePieceTokenizer(p) for lang, p in paths.items()})


def download_from_hf(repo_id: str, cache_dir: str | None = None) -> str:
    """HuggingFace-hub download of a .nemo artifact (the reference's
    from_pretrained path). Needs the ``huggingface_hub`` package and the
    network; without the package it raises ImportError."""
    from huggingface_hub import hf_hub_download, list_repo_files

    files = list_repo_files(repo_id)
    nemo = [f for f in files if f.endswith(".nemo")]
    if not nemo:
        raise FileNotFoundError(f"no .nemo file in {repo_id}: {files}")
    return hf_hub_download(repo_id, nemo[0], cache_dir=cache_dir)


def restore_pretrained(nemo_path: str, work_dir: str, dtype: torch.dtype | None = None,
                       with_tokenizer: bool = True, device=None, timings: dict | None = None):
    """.nemo -> (model, model_cfg, tokenizer or None): parse the config,
    build the model on ``device`` (the card unless "cpu" is given), load
    the converted weights with a strict load (a missing, extra or
    mis-shaped leaf raises and names it) and the SentencePiece tokenizers.
    ``timings``, when given, gets the seconds of each part."""
    times: dict = {}
    t0 = time.perf_counter()
    cfg = read_nemo_config(nemo_path)
    model_cfg = model_config_from_nemo(cfg, dtype=dtype)
    model = HybridRNNTCTC(model_cfg, device=device)
    times["config_s"] = time.perf_counter() - t0
    tree = load_pretrained(nemo_path, model_cfg, timings=times)
    t0 = time.perf_counter()
    from_jax_variables(model, tree)
    del tree
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    times["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokenizer = build_tokenizer_from_nemo(nemo_path, work_dir, cfg=cfg) if with_tokenizer else None
    times["tokenizer_s"] = time.perf_counter() - t0
    if timings is not None:
        timings.update(times)
    return model, model_cfg, tokenizer
