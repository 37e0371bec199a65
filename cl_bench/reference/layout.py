"""The parameter layout of the hybrid RNNT+CTC Conformer, by name and
shape, and the seeded weights the benchmark hands to both sides.

The names are the layout of the checkpoint the port reads and writes (its
``state_dict``): the benchmark loads the weights it makes into the program
strictly by these names, so a layout that drifts fails at load.
"""

from __future__ import annotations

import math

import torch


def subsampled_feat_dim(m: dict) -> int:
    f = m["feat_in"]
    for _ in range(int(math.log2(m["subsampling_factor"]))):
        f = (f + 2 - 3) // 2 + 1
    return f


def specs(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter and statistic, where init is
    ``"normal:<std>"``, ``"zeros"`` or ``"ones"``."""
    d, H = m["d_model"], m["n_heads"]
    C = d if m["subsampling_conv_channels"] == -1 else m["subsampling_conv_channels"]
    dff = d * m["ff_expansion_factor"]
    k = m["conv_kernel_size"]
    V, L = m["vocab_size_total"], m["n_langs"]
    Hp, Hj = m["pred_hidden"], m["joint_hidden"]
    V1 = V // L + 1
    out: list[tuple[str, tuple, str]] = []

    def lin(name, o, i, bias=True):
        out.append((f"{name}.weight", (o, i), f"normal:{i ** -0.5}"))
        if bias:
            out.append((f"{name}.bias", (o,), "zeros"))

    def norm(name):
        out.append((f"{name}.weight", (d,), "ones"))
        out.append((f"{name}.bias", (d,), "zeros"))

    for i in range(int(math.log2(m["subsampling_factor"]))):
        cin = 1 if i == 0 else C
        out.append((f"encoder.pre_encode.convs.{i}.weight", (C, cin, 3, 3), f"normal:{(cin * 9) ** -0.5}"))
        out.append((f"encoder.pre_encode.convs.{i}.bias", (C,), "zeros"))
    lin("encoder.pre_encode.out", d, C * subsampled_feat_dim(m))
    for n in range(m["n_layers"]):
        p = f"encoder.layers.{n}"
        norm(f"{p}.norm_feed_forward1")
        lin(f"{p}.feed_forward1.linear1", dff, d)
        lin(f"{p}.feed_forward1.linear2", d, dff)
        norm(f"{p}.norm_self_att")
        out.append((f"{p}.self_attn.pos_bias_u", (H, d // H), "zeros"))
        out.append((f"{p}.self_attn.pos_bias_v", (H, d // H), "zeros"))
        for q in ("linear_q", "linear_k", "linear_v"):
            lin(f"{p}.self_attn.{q}", d, d)
        lin(f"{p}.self_attn.linear_pos", d, d, bias=False)
        lin(f"{p}.self_attn.linear_out", d, d)
        norm(f"{p}.norm_conv")
        lin(f"{p}.conv.pointwise_conv1", 2 * d, d)
        out.append((f"{p}.conv.depthwise_conv.weight", (d, 1, k), f"normal:{k ** -0.5}"))
        out.append((f"{p}.conv.depthwise_conv.bias", (d,), "zeros"))
        norm(f"{p}.conv.batch_norm")
        out.append((f"{p}.conv.batch_norm.running_mean", (d,), "zeros"))
        out.append((f"{p}.conv.batch_norm.running_var", (d,), "ones"))
        lin(f"{p}.conv.pointwise_conv2", d, d)
        norm(f"{p}.norm_feed_forward2")
        lin(f"{p}.feed_forward2.linear1", dff, d)
        lin(f"{p}.feed_forward2.linear2", d, dff)
        norm(f"{p}.norm_out")
    out.append(("prediction.embedding", (V + 1, Hp), "normal:1.0"))
    for n in range(m["pred_rnn_layers"]):
        out.append((f"prediction.lstm.{n}.w_ih", (Hp, 4 * Hp), f"normal:{Hp ** -0.5}"))
        out.append((f"prediction.lstm.{n}.w_hh", (Hp, 4 * Hp), f"normal:{Hp ** -0.5}"))
        out.append((f"prediction.lstm.{n}.bias", (4 * Hp,), "zeros"))
    out.append(("joint.head_kernel", (L, Hj, V1), f"normal:{Hj ** -0.5}"))
    out.append(("joint.head_bias", (L, V1), "zeros"))
    lin("joint.enc", Hj, d)
    lin("joint.pred", Hj, Hp)
    out.append(("ctc_decoder.kernel", (d, V + 1), f"normal:{d ** -0.5}"))
    out.append(("ctc_decoder.bias", (V + 1,), "zeros"))
    return out


def is_trainable(name: str, frozen_till: int) -> bool:
    """The CL config's freeze rule: pre_encode and encoder layers
    [0, frozen_till) take no update."""
    if name.endswith(("running_mean", "running_var")):
        return False
    if frozen_till <= 0:
        return True
    if name.startswith("encoder.pre_encode."):
        return False
    if name.startswith("encoder.layers."):
        return int(name.split(".")[2]) >= frozen_till
    return True


# residual-branch output projections, scaled down for the eval cell
RESIDUAL_OUTPUTS = ("feed_forward1.linear2.weight", "feed_forward2.linear2.weight",
                    "self_attn.linear_out.weight", "conv.pointwise_conv2.weight")


def make_weights(m: dict, seed: int, device, serving: bool = False) -> dict[str, torch.Tensor]:
    """Every tensor of the layout in f32 on ``device``, the random ones
    from one normal draw of a generator seeded with ``seed`` on that
    device. ``serving`` (the eval cell) scales the residual branches' output
    projections by 0.1 (a deep random Conformer otherwise maps every frame
    to nearly one vector) and both heads by 8 (so the top logits have
    margins); the blank biases are set afterwards (``calibrate``)."""
    sp = specs(m)
    n_random = sum(math.prod(s) for _, s, init in sp if init.startswith("normal"))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n_random, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in sp:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape) * float(init.split(":")[1])
            at += n
    if serving:
        for name in out:
            if name.endswith(RESIDUAL_OUTPUTS):
                out[name] *= 0.1
        out["joint.head_kernel"] *= 8.0
        out["ctc_decoder.kernel"] *= 8.0
    return out
