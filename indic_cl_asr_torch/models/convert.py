"""Load the JAX package's Flax variables into the port's modules.

``from_jax_variables(model, variables)`` takes the JAX ``variables``
(``params`` + ``batch_stats``) as a nested dict of numpy arrays and loads
every parameter and BatchNorm statistic of the port's HybridRNNTCTC.
Every leaf maps on its own (``port_leaf``), so the same mapping serves a
whole tree and a partial save of named leaves
(``utils/checkpoint.py:load_partial``):

  * Dense kernels [in, out] become Linear weights [out, in];
  * the subsampling Conv kernels HWIO [3, 3, in, out] become OIHW;
  * the depthwise Conv kernel [k, 1, C] becomes Conv1d [C, 1, k];
  * LayerNorm / BatchNorm ``scale`` becomes ``weight``, the BatchNorm
    statistics ``mean`` / ``var`` become ``running_mean`` / ``running_var``;
    the conv module's ``layer_norm`` / ``group_norm<N>`` (still named
    ``batch_norm``) carries scale and bias and no statistics, and the
    subsampling convs any ``subsampling_conv_channels``: the same rules
    load them;
  * the encoder layers load from either layout: the scanned stack
    (``encoder/stack/layers/<leaf>[L, ...]``, the flagship's) split per
    layer, or the unrolled ``encoder/layers_<i>``;
  * the LSTM, the joint head and the CTC head keep the JAX layout.

The same mapping serves any tree shaped like the parameters: a gradient
tree or updated parameters (``jax_state_dict({"params": grads}, L)``),
so tests compare gradients and updates name by name. BatchNorm statistics
are mapped where ``batch_stats`` is given.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_STACK = re.compile(r"^(.*encoder)/stack/layers/(.*)$")
_RENAMES = ((re.compile(r"^layers_(\d+)$"), r"layers.\1"),
            (re.compile(r"^conv_(\d+)$"), r"convs.\1"),
            (re.compile(r"^lstm_(\d+)$"), r"lstm.\1"))
# kernel layouts by rank: Dense [in, out], depthwise [k, 1, C], Conv2d HWIO
_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _rename(part: str) -> str:
    for pattern, repl in _RENAMES:
        part = pattern.sub(repl, part)
    return part


def port_leaf(path: str, arr) -> tuple[str, np.ndarray]:
    """One JAX leaf, by its '/'-joined path below ``params`` or
    ``batch_stats`` (unrolled layout), -> (port state-dict name, array in
    the port's layout)."""
    *mods, leaf = path.split("/")
    mod = ".".join(_rename(part) for part in mods)
    arr = np.asarray(arr)
    if leaf == "kernel" and mod != "ctc_decoder":
        arr, leaf = np.transpose(arr, _KERNEL_AXES[arr.ndim]), "weight"
    return f"{mod}.{_LEAVES.get(leaf, leaf)}", arr


_INDEXED = {"layers": "layers_", "convs": "conv_", "lstm": "lstm_"}
_JAX_LEAVES = {"running_mean": "mean", "running_var": "var"}


def jax_path(name: str, ndim: int) -> tuple[str, tuple | None]:
    """The inverse of ``port_leaf`` for names: a port state-dict name of a
    tensor of ``ndim`` dims -> (its JAX path below ``params`` or
    ``batch_stats``, unrolled layout; the ``_KERNEL_AXES`` the port's
    layout took from the JAX one, None where it kept it). JAX dim j is
    port dim ``axes.index(j)``."""
    *mods, leaf = name.split(".")
    parts, i = [], 0
    while i < len(mods):
        if mods[i] in _INDEXED and i + 1 < len(mods) and mods[i + 1].isdigit():
            parts.append(_INDEXED[mods[i]] + mods[i + 1])
            i += 2
        else:
            parts.append(mods[i])
            i += 1
    axes = None
    if leaf == "weight":
        leaf, axes = ("kernel", _KERNEL_AXES[ndim]) if ndim >= 2 else ("scale", None)
    return "/".join(parts + [_JAX_LEAVES.get(leaf, leaf)]), axes


def named_state_dict(named: dict) -> dict[str, np.ndarray]:
    """{JAX path: array} -> {port name: array}. A path may carry its
    collection (``params/...``, ``batch_stats/...``) or be relative to
    ``params`` (a partial save's names); a scanned-stack leaf gives one
    entry per row it holds."""
    sd: dict[str, np.ndarray] = {}
    for path, arr in named.items():
        path = re.sub(r"^(params|batch_stats)/", "", path)
        m = _STACK.match(path)
        if m is None:
            name, value = port_leaf(path, arr)
            sd[name] = value
            continue
        for i, row in enumerate(np.asarray(arr)):
            name, value = port_leaf(f"{m.group(1)}/layers_{i}/{m.group(2)}", row)
            sd[name] = value
    return sd


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def jax_state_dict(variables: dict, n_layers: int) -> dict[str, np.ndarray]:
    """Flax variables -> the port's state-dict names and layouts (numpy);
    the BatchNorm statistics only when ``variables`` has ``batch_stats``.
    A scanned stack must hold ``n_layers`` rows."""
    sd = named_state_dict({f"{c}/{k}": v for c in ("params", "batch_stats")
                           if c in variables for k, v in _named(variables[c]).items()})
    extra = [n for n in sd if n.startswith("encoder.layers.")
             and int(n.split(".")[2]) >= n_layers]
    if extra:
        raise ValueError(f"variables hold more than {n_layers} encoder layers: {extra[:3]}")
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
