"""Load the JAX package's Flax variables into the port's modules.

``from_jax_variables(model, variables)`` takes the JAX ``variables``
(``params`` + ``batch_stats``) as a nested dict of numpy arrays and loads
every parameter and BatchNorm statistic of the port's HybridRNNTCTC:

  * Dense kernels [in, out] become Linear weights [out, in];
  * the subsampling Conv kernels HWIO [3, 3, in, out] become OIHW;
  * the depthwise Conv kernel [k, 1, C] becomes Conv1d [C, 1, k];
  * LayerNorm / BatchNorm ``scale`` becomes ``weight``;
  * the encoder layers load from either layout: the scanned stack
    (``encoder/stack/layers/<leaf>[L, ...]``, the flagship's) split per
    layer, or the unrolled ``encoder/layers_<i>``;
  * the LSTM, the joint head and the CTC head keep the JAX layout.
"""

from __future__ import annotations

import numpy as np
import torch


def _dense(sd, prefix, tree):
    sd[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
    if "bias" in tree:
        sd[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _norm(sd, prefix, tree):
    sd[f"{prefix}.weight"] = np.asarray(tree["scale"])
    sd[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _layer(sd, prefix, p, bs):
    for name in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                 "norm_feed_forward2", "norm_out"):
        _norm(sd, f"{prefix}.{name}", p[name])
    for ff in ("feed_forward1", "feed_forward2"):
        for lin in ("linear1", "linear2"):
            _dense(sd, f"{prefix}.{ff}.{lin}", p[ff][lin])
    att = p["self_attn"]
    for lin in ("linear_q", "linear_k", "linear_v", "linear_pos", "linear_out"):
        _dense(sd, f"{prefix}.self_attn.{lin}", att[lin])
    sd[f"{prefix}.self_attn.pos_bias_u"] = np.asarray(att["pos_bias_u"])
    sd[f"{prefix}.self_attn.pos_bias_v"] = np.asarray(att["pos_bias_v"])
    conv = p["conv"]
    _dense(sd, f"{prefix}.conv.pointwise_conv1", conv["pointwise_conv1"])
    _dense(sd, f"{prefix}.conv.pointwise_conv2", conv["pointwise_conv2"])
    dw = conv["depthwise_conv"]
    sd[f"{prefix}.conv.depthwise_conv.weight"] = np.transpose(
        np.asarray(dw["kernel"]), (2, 1, 0)
    )
    sd[f"{prefix}.conv.depthwise_conv.bias"] = np.asarray(dw["bias"])
    _norm(sd, f"{prefix}.conv.batch_norm", conv["batch_norm"])
    stats = bs["conv"]["batch_norm"]
    sd[f"{prefix}.conv.batch_norm.running_mean"] = np.asarray(stats["mean"])
    sd[f"{prefix}.conv.batch_norm.running_var"] = np.asarray(stats["var"])


def _slice(tree, i):
    return {k: _slice(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def jax_state_dict(variables: dict, n_layers: int) -> dict[str, np.ndarray]:
    """Flax variables -> the port's state-dict names and layouts (numpy)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    enc = params["encoder"]
    enc_bs = stats.get("encoder", {})
    sd: dict[str, np.ndarray] = {}
    pre = enc["pre_encode"]
    i = 0
    while f"conv_{i}" in pre:
        conv = pre[f"conv_{i}"]
        sd[f"encoder.pre_encode.convs.{i}.weight"] = np.transpose(
            np.asarray(conv["kernel"]), (3, 2, 0, 1)
        )
        sd[f"encoder.pre_encode.convs.{i}.bias"] = np.asarray(conv["bias"])
        i += 1
    _dense(sd, "encoder.pre_encode.out", pre["out"])
    for li in range(n_layers):
        if "stack" in enc:
            p = _slice(enc["stack"]["layers"], li)
            bs = _slice(enc_bs["stack"]["layers"], li)
        else:
            p = enc[f"layers_{li}"]
            bs = enc_bs[f"layers_{li}"]
        _layer(sd, f"encoder.layers.{li}", p, bs)
    pred = params["prediction"]
    sd["prediction.embedding"] = np.asarray(pred["embedding"])
    li = 0
    while f"lstm_{li}" in pred:
        for leaf in ("w_ih", "w_hh", "bias"):
            sd[f"prediction.lstm.{li}.{leaf}"] = np.asarray(pred[f"lstm_{li}"][leaf])
        li += 1
    joint = params["joint"]
    _dense(sd, "joint.enc", joint["enc"])
    _dense(sd, "joint.pred", joint["pred"])
    sd["joint.head_kernel"] = np.asarray(joint["head_kernel"])
    sd["joint.head_bias"] = np.asarray(joint["head_bias"])
    ctc = params["ctc_decoder"]
    sd["ctc_decoder.kernel"] = np.asarray(ctc["kernel"])
    sd["ctc_decoder.bias"] = np.asarray(ctc["bias"])
    return sd


@torch.no_grad()
def from_jax_variables(model, variables: dict):
    """Load Flax ``variables`` (nested dict of numpy arrays) into ``model``
    in place, in its dtype and on its device; returns the model."""
    sd = jax_state_dict(variables, model.cfg.encoder.n_layers)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"layout mismatch: missing {missing}, unexpected {extra}")
    for name, arr in sd.items():
        dst = own[name]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: {tuple(arr.shape)} != {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model
