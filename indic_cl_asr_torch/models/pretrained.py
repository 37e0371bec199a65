"""Checkpoint conversion: a NeMo ``.nemo`` / torch state dict -> the port's model.

Port of indic_cl_asr_tpu/models/pretrained.py. The reference loads
``ai4bharat/indicconformer_stt_hi_hybrid_rnnt_large`` through NeMo's
SaveRestoreConnector (a tar of model_config.yaml + model_weights.ckpt;
cl_baseline.py:122). ``convert_nemo_state_dict`` maps that state dict onto
the JAX package's parameter tree (numpy, the same names and layouts), and
``nemo_ingest.restore_pretrained`` loads the tree into the port's modules
through models/convert.py's per-leaf mapping (a strict load), so the
NeMo -> JAX layout rules live here once and the JAX function is the
oracle leaf for leaf:

  Conv2d   [O, I, kh, kw]            -> kernel [kh, kw, I, O]
  Conv1d k=1 (pointwise/CTC head)    [O, I, 1] -> kernel [I, O]
  depthwise Conv1d [C, 1, k]         -> kernel [k, 1, C]
  Linear   [O, I]                    -> kernel [I, O]
  LSTM     weight_ih_l0 [4H, I]      -> w_ih [I, 4H];  bias = b_ih + b_hh
  subsampling out-proj: NeMo flattens the conv output channel-major
  (C, F), the JAX package (and the port) feature-major (F, C): the dense's
  input dim is permuted accordingly.
  per-language joint heads: ModuleDict[lang] Linears -> a stacked
  [L, H, V+1] kernel (+ [L, V+1] bias), in the fixed order of
  ``LANGUAGE_KEYS`` (or one plain head replicated per language).

One difference: the conv norm's running statistics are taken only where
the state dict has them. NeMo's LayerNorm and GroupNorm keep none, so a
``layer_norm`` / ``group_norm<N>`` checkpoint converts; the JAX function
reads them unconditionally (a KeyError there).
"""

from __future__ import annotations

import io
import tarfile
import time
from typing import Mapping

import numpy as np
import torch

from .conformer import subsampled_feat_dim

# the head order of every converted checkpoint (the JAX package's
# load_pretrained), whatever order the .nemo's config lists its languages in
LANGUAGE_KEYS = ["hi", "bn", "mr", "te", "ta", "ur", "gu", "kn", "or", "ml", "pa", "sa"]


def _t(x):
    return np.asarray(x).T


def _conv2d(x):
    return np.transpose(np.asarray(x), (2, 3, 1, 0))


def _pointwise1d(x):
    return np.asarray(x)[:, :, 0].T


def _depthwise1d(x):
    return np.transpose(np.asarray(x), (2, 1, 0))


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """model_weights.ckpt from a .nemo tar (or a bare .ckpt/.pth) -> numpy
    arrays (views of the loaded tensors). ``torch.load`` keeps its default
    ``weights_only``."""
    if path.endswith(".nemo") or tarfile.is_tarfile(path):
        with tarfile.open(path) as tar:
            names = [m.name for m in tar.getmembers()
                     if m.name.endswith(("model_weights.ckpt", ".ckpt", ".pt"))]
            if not names:
                raise FileNotFoundError(f"no weights member found in {path}")
            raw = tar.extractfile(names[0]).read()
        sd = torch.load(io.BytesIO(raw), map_location="cpu")
        del raw
    else:
        sd = torch.load(path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def _stack(trees: list):
    """Per-layer subtrees -> one tree of [L, ...] arrays (numpy)."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def convert_nemo_state_dict(
    sd: Mapping[str, np.ndarray],
    *,
    n_layers: int,
    sampling_num: int,
    subsampled_feat: int,
    conv_channels: int,
    language_keys: list[str],
    scan_layers: bool = False,
) -> dict:
    """NeMo hybrid RNNT+CTC BPE state dict -> {"params", "batch_stats"}, the
    JAX package's tree (nested dicts of f32 numpy arrays). With
    ``scan_layers`` the per-layer encoder subtrees are stacked along a
    leading [L] axis under ``encoder/stack/layers`` (both layouts load
    into the port)."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value, np.float32)

    # ---- encoder: subsampling ----
    enc: dict = {}
    for i in range(sampling_num):
        j = 2 * i  # Conv2d, ReLU pairs
        put(enc, (f"conv_{i}", "kernel"), _conv2d(sd[f"encoder.pre_encode.conv.{j}.weight"]))
        put(enc, (f"conv_{i}", "bias"), sd[f"encoder.pre_encode.conv.{j}.bias"])
    w = np.asarray(sd["encoder.pre_encode.out.weight"])  # [d, C*F], channel-major
    C, F = conv_channels, subsampled_feat
    w = w.reshape(-1, C, F).transpose(0, 2, 1).reshape(-1, F * C)
    put(enc, ("out", "kernel"), w.T)
    put(enc, ("out", "bias"), sd["encoder.pre_encode.out.bias"])
    params["encoder"] = {"pre_encode": enc}

    # ---- encoder layers ----
    for i in range(n_layers):
        p = f"encoder.layers.{i}."
        layer: dict = {}
        for ln in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                   "norm_feed_forward2", "norm_out"):
            put(layer, (ln, "scale"), sd[p + ln + ".weight"])
            put(layer, (ln, "bias"), sd[p + ln + ".bias"])
        for ff in ("feed_forward1", "feed_forward2"):
            for lin in ("linear1", "linear2"):
                put(layer, (ff, lin, "kernel"), _t(sd[p + f"{ff}.{lin}.weight"]))
                put(layer, (ff, lin, "bias"), sd[p + f"{ff}.{lin}.bias"])
        att: dict = {}
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
            put(att, (lin, "kernel"), _t(sd[p + f"self_attn.{lin}.weight"]))
            put(att, (lin, "bias"), sd[p + f"self_attn.{lin}.bias"])
        put(att, ("linear_pos", "kernel"), _t(sd[p + "self_attn.linear_pos.weight"]))
        put(att, ("pos_bias_u",), sd[p + "self_attn.pos_bias_u"])
        put(att, ("pos_bias_v",), sd[p + "self_attn.pos_bias_v"])
        layer["self_attn"] = att
        conv: dict = {}
        put(conv, ("pointwise_conv1", "kernel"), _pointwise1d(sd[p + "conv.pointwise_conv1.weight"]))
        put(conv, ("pointwise_conv1", "bias"), sd[p + "conv.pointwise_conv1.bias"])
        put(conv, ("depthwise_conv", "kernel"), _depthwise1d(sd[p + "conv.depthwise_conv.weight"]))
        put(conv, ("depthwise_conv", "bias"), sd[p + "conv.depthwise_conv.bias"])
        put(conv, ("batch_norm", "scale"), sd[p + "conv.batch_norm.weight"])
        put(conv, ("batch_norm", "bias"), sd[p + "conv.batch_norm.bias"])
        put(conv, ("pointwise_conv2", "kernel"), _pointwise1d(sd[p + "conv.pointwise_conv2.weight"]))
        put(conv, ("pointwise_conv2", "bias"), sd[p + "conv.pointwise_conv2.bias"])
        layer["conv"] = conv
        params["encoder"][f"layers_{i}"] = layer
        for ours, theirs in (("mean", "running_mean"), ("var", "running_var")):
            if p + f"conv.batch_norm.{theirs}" in sd:
                put(stats, ("encoder", f"layers_{i}", "conv", "batch_norm", ours),
                    sd[p + f"conv.batch_norm.{theirs}"])

    if scan_layers:
        for tree in (params, stats):
            if "encoder" not in tree:
                continue
            per = [tree["encoder"].pop(f"layers_{i}") for i in range(n_layers)]
            tree["encoder"]["stack"] = {"layers": _stack(per)}

    # ---- prediction net ----
    pred = {"embedding": np.asarray(sd["decoder.prediction.embed.weight"], np.float32)}
    lp = "decoder.prediction.dec_rnn.lstm."
    k = 0
    while f"{lp}weight_ih_l{k}" in sd:
        pred[f"lstm_{k}"] = {
            "w_ih": _t(sd[f"{lp}weight_ih_l{k}"]).astype(np.float32),
            "w_hh": _t(sd[f"{lp}weight_hh_l{k}"]).astype(np.float32),
            "bias": (np.asarray(sd[f"{lp}bias_ih_l{k}"])
                     + np.asarray(sd[f"{lp}bias_hh_l{k}"])).astype(np.float32),
        }
        k += 1
    params["prediction"] = pred

    # ---- joint ----
    joint = {
        "enc": {"kernel": _t(sd["joint.enc.weight"]).astype(np.float32),
                "bias": np.asarray(sd["joint.enc.bias"], np.float32)},
        "pred": {"kernel": _t(sd["joint.pred.weight"]).astype(np.float32),
                 "bias": np.asarray(sd["joint.pred.bias"], np.float32)},
    }
    # the final layer: a per-language ModuleDict (5-part keys
    # joint.joint_net.<i>.<lang>.weight) or one plain Linear (4-part keys:
    # the HIGHEST Sequential index; lower ones are intermediate linears)
    head_idx = None
    single: list[int] = []
    for key in sd:
        if key.startswith("joint.joint_net.") and key.endswith(".weight"):
            parts = key.split(".")
            if len(parts) == 5:
                head_idx = parts[2]
                break
            if len(parts) == 4:
                single.append(int(parts[2]))
    if head_idx is None and single:
        head_idx = str(max(single))
    if head_idx is None:
        raise KeyError("no joint final layer (joint.joint_net.<i>[.<lang>].weight) found")
    if any(f"joint.joint_net.{head_idx}.{l}.weight" in sd for l in language_keys):
        ws = [_t(sd[f"joint.joint_net.{head_idx}.{l}.weight"]) for l in language_keys]
        bs = [np.asarray(sd[f"joint.joint_net.{head_idx}.{l}.bias"]) for l in language_keys]
        joint["head_kernel"] = np.stack(ws).astype(np.float32)  # [L, H, V+1]
        joint["head_bias"] = np.stack(bs).astype(np.float32)
    else:  # single-softmax checkpoint: the one head replicated per language
        w = _t(sd[f"joint.joint_net.{head_idx}.weight"])
        b = np.asarray(sd[f"joint.joint_net.{head_idx}.bias"])
        joint["head_kernel"] = np.repeat(w[None], len(language_keys), axis=0).astype(np.float32)
        joint["head_bias"] = np.repeat(b[None], len(language_keys), axis=0).astype(np.float32)
    params["joint"] = joint

    # ---- ctc head ----
    params["ctc_decoder"] = {
        "kernel": _pointwise1d(sd["ctc_decoder.decoder_layers.0.weight"]).astype(np.float32),
        "bias": np.asarray(sd["ctc_decoder.decoder_layers.0.bias"], np.float32),
    }
    return {"params": params, "batch_stats": stats}


def load_pretrained(nemo_path: str, model_cfg, timings: dict | None = None) -> dict:
    """.nemo file -> the converted tree for a HybridModelConfig's shapes,
    its heads the first ``n_langs`` of ``LANGUAGE_KEYS``. ``timings``, when
    given, gets the seconds of the read and of the conversion."""
    t0 = time.perf_counter()
    sd = load_torch_state_dict(nemo_path)
    t1 = time.perf_counter()
    enc = model_cfg.encoder
    tree = convert_nemo_state_dict(
        sd, n_layers=enc.n_layers, sampling_num=enc.sampling_num,
        subsampled_feat=subsampled_feat_dim(enc), conv_channels=enc.conv_channels,
        language_keys=LANGUAGE_KEYS[: model_cfg.n_langs],
    )
    if timings is not None:
        timings.update(read_s=t1 - t0, convert_s=time.perf_counter() - t1)
    return tree
