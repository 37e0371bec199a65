"""The encoder and joint options a ``.nemo`` config names, in the port
against the JAX package, on the CPU in f32 at ``tiny_config()`` widths
(dropout 0):

  * ``conv_norm_type`` "layer_norm", "group_norm" and "group_norm2" (Flax's
    norms: eps 1e-6, f32 statistics; GroupNorm over every frame of the
    padded T), ``subsampling_conv_channels`` != d_model and
    ``xscale=False``: the encoder's output (and BatchNorm statistics in
    train mode) in eval and train mode, rows of unequal length, atol 5e-5
    on the outputs (f32 sums in another order through two layers, the
    batch statistics in train mode; measured up to 1.7e-5) and 1e-5 on the
    statistics;
  * ``causal_conv`` and the Longformer ``global_tokens`` variants (spacing,
    separate global projections, with a band, on a flash config, which
    both packages send to their eager/XLA attention), at the same bars;
    the global projections load from the scanned layout too;
  * the joint activation "tanh" and "sigmoid": ``step_logits`` and the
    chunked RNNT loss with its gradients, atol 1e-5; ``resolve_decoders``
    on a non-relu joint; one train step with ``rnnt_impl="pallas"`` equal
    to the ``"xla"`` step (the activation reaches the loss, which takes
    the chunked path).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.models.hybrid import HybridRNNTCTC as HybridRNNTCTC_J
from indic_cl_asr_tpu.models.hybrid import init_model
from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config
from indic_cl_asr_tpu.ops.rnnt_loss_fused import rnnt_loss_fused as jax_rnnt_loss_fused
from indic_cl_asr_torch.audio.features import FrontendConfig
from indic_cl_asr_torch.models.conformer import GroupNorm, attention_route, batch_stats_frozen
from indic_cl_asr_torch.models.convert import from_jax_variables, jax_state_dict
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, tiny_config
from indic_cl_asr_torch.ops.rnnt_loss_fused import rnnt_loss_fused
from indic_cl_asr_torch.train.eval import Transcriber, resolve_decoders
from indic_cl_asr_torch.train.state import make_optimizer
from indic_cl_asr_torch.train.step import StepConfig, make_train_step

ATOL = 1e-5
ENC_ATOL = 5e-5


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def random_variables(jcfg, rng):
    """numpy variables of the JAX model's shapes (``jax.eval_shape``, no
    init run): kernels N(0, 1/fan_in), scales 1 + N(0, 0.2²), other leaves
    N(0, 0.2²), BatchNorm variances 0.5 + |N(0, 1)|."""

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "var" in name and path[0].key == "batch_stats":
            v = 0.5 + np.abs(rng.standard_normal(x.shape))
        elif "kernel" in name or "w_" in name:
            v = rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        elif "scale" in name:
            v = 1.0 + 0.2 * rng.standard_normal(x.shape)
        else:
            v = 0.2 * rng.standard_normal(x.shape)
        return v.astype(np.float32)

    shapes = jax.eval_shape(lambda: init_model(jcfg, jax.random.PRNGKey(0))[1])
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pair(seed=0, encoder=None, **overrides):
    """(flax module, numpy variables, port model) on one set of weights."""
    jcfg, pcfg = jax_tiny_config(**overrides), tiny_config(**overrides)
    if encoder:
        jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(jcfg.encoder, **encoder))
        pcfg = dataclasses.replace(pcfg, encoder=dataclasses.replace(pcfg.encoder, **encoder))
    var_np = random_variables(jcfg, np.random.default_rng(seed))
    model = HybridRNNTCTC_J(jcfg)
    return model, var_np, from_jax_variables(HybridRNNTCTC(pcfg, device="cpu"), var_np)


ENCODER_OPTIONS = {
    "layer_norm": dict(conv_norm_type="layer_norm"),
    "group_norm": dict(conv_norm_type="group_norm"),
    "group_norm2": dict(conv_norm_type="group_norm2"),
    "conv_channels_24": dict(subsampling_conv_channels=24),
    "no_xscale": dict(xscale=False),
    "causal_conv": dict(causal_conv=True),
    "causal_conv_band": dict(causal_conv=True, att_context_size=(8, 0)),
    "global_tokens": dict(global_tokens=3),
    "global_spacing": dict(global_tokens=3, global_tokens_spacing=5),
    "global_separate": dict(global_tokens=2, global_tokens_spacing=6,
                            global_attn_separate=True),
    "global_band": dict(global_tokens=2, global_tokens_spacing=9, att_context_size=(3, 2)),
    "global_flash": dict(global_tokens=2, global_tokens_spacing=4, attn_impl="flash"),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("option", list(ENCODER_OPTIONS))
def test_encoder_option_matches_jax(option, train):
    model, var_np, port = pair(seed=3, encoder=ENCODER_OPTIONS[option])
    norm = port.encoder.layers[0].conv.batch_norm
    assert isinstance(norm, GroupNorm) == option.startswith(("layer", "group"))
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((3, 32, 72)).astype(np.float32)
    lens = np.array([72, 45, 20], np.int32)  # unequal rows: GroupNorm sees the padding
    kw = dict(mutable=["batch_stats"]) if train else {}
    out = jax.jit(lambda v, x, n: model.apply(v, x, n, train, method="encode", **kw))(
        var_np, feats, lens)
    (f_j, l_j), new_vars = out if train else (out, None)
    port.train(train)
    f_t, l_t = port.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j), atol=ENC_ATOL, rtol=0)
    if train and "batch_stats" in var_np:
        want = jax_state_dict({"batch_stats": _np(new_vars["batch_stats"])}, 2)
        got = port.state_dict()
        for name, arr in want.items():
            np.testing.assert_allclose(got[name].numpy(), arr, atol=ATOL, rtol=0)
    if option.startswith(("layer", "group")):
        assert "batch_stats" not in var_np  # no running statistics to freeze
        with batch_stats_frozen(port):
            port.encode(torch.from_numpy(feats), torch.from_numpy(lens))


def test_global_tokens_take_the_eager_route():
    """A flash config with global tokens runs the eager attention, resolved
    at construction (the JAX module sends it to XLA); without them the
    flash route stays."""
    for g, route in ((0, "flash"), (2, "xla")):
        enc = dataclasses.replace(tiny_config().encoder, attn_impl="flash", global_tokens=g)
        port = HybridRNNTCTC(tiny_config(encoder=enc), device="cpu")
        assert attention_route(enc) == route == port.encoder.attention_route
        assert all(layer.self_attn.route == route for layer in port.encoder.layers)


def test_global_projections_load_from_the_scanned_layout():
    """``global_q/k/v`` of a scanned JAX encoder (``stack/layers`` [L, ...])
    load into the port's layers, and the encoders agree."""
    opts = dict(global_tokens=2, global_tokens_spacing=3, global_attn_separate=True)
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(jcfg.encoder, scan_layers=True,
                                                                 **opts))
    pcfg = tiny_config()
    pcfg = dataclasses.replace(pcfg, encoder=dataclasses.replace(pcfg.encoder, **opts))
    var_np = random_variables(jcfg, np.random.default_rng(8))
    stack = var_np["params"]["encoder"]["stack"]["layers"]["self_attn"]
    assert stack["global_q"]["kernel"].shape == (2, 64, 64)
    port = from_jax_variables(HybridRNNTCTC(pcfg, device="cpu"), var_np)
    np.testing.assert_array_equal(port.encoder.layers[1].self_attn.global_v.weight.numpy(),
                                  stack["global_v"]["kernel"][1].T)
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((2, 32, 48)).astype(np.float32)
    lens = np.array([48, 30], np.int32)
    f_j, _ = jax.jit(lambda v, x, n: HybridRNNTCTC_J(jcfg).apply(v, x, n, False,
                                                                 method="encode"))(
        var_np, feats, lens)
    f_t, _ = port.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=ENC_ATOL, rtol=0)


def test_group_norm_result_depends_on_the_padding():
    """GroupNorm's statistics include the padded frames, as Flax's do: the
    same valid frames give another result under more padding."""
    _, _, port = pair(encoder=dict(conv_norm_type="group_norm"))
    norm = port.encoder.layers[0].conv.batch_norm
    x = torch.randn(1, 64, 10)
    padded = torch.cat([x, torch.zeros(1, 64, 6)], dim=2)
    assert not torch.allclose(norm(x), norm(padded)[:, :, :10], atol=1e-3)


def test_unknown_options_raise():
    enc = dataclasses.replace(tiny_config().encoder, conv_norm_type="instance_norm")
    with pytest.raises(ValueError, match="conv_norm_type"):
        HybridRNNTCTC(tiny_config(encoder=enc), device="cpu")
    enc = dataclasses.replace(tiny_config().encoder, conv_norm_type="group_norm3")
    with pytest.raises(ValueError, match="groups"):
        HybridRNNTCTC(tiny_config(encoder=enc), device="cpu")
    with pytest.raises(ValueError, match="activation"):
        HybridRNNTCTC(tiny_config(joint_activation="gelu"), device="cpu")


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
def test_joint_step_logits_match_jax(activation):
    model, var_np, port = pair(seed=2, joint_activation=activation)
    assert port.joint.cfg.activation == activation
    rng = np.random.default_rng(2)
    f = rng.standard_normal((3, 32)).astype(np.float32)
    g = rng.standard_normal((3, 32)).astype(np.float32)
    lang = np.array([0, 3, 1], np.int32)
    want = model.apply(var_np, jnp.asarray(f), jnp.asarray(g), jnp.asarray(lang),
                       method="joint_step")
    got = port.joint_step(torch.from_numpy(f), torch.from_numpy(g), torch.from_numpy(lang))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
def test_chunked_rnnt_loss_matches_jax(activation):
    rng = np.random.default_rng(7)
    B, T, U, H, V1 = 3, 11, 4, 16, 9
    f = rng.standard_normal((B, T, H)).astype(np.float32)
    g = rng.standard_normal((B, U + 1, H)).astype(np.float32)
    w = (0.5 * rng.standard_normal((B, H, V1))).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, V1))).astype(np.float32)
    labels = rng.integers(0, V1 - 1, (B, U)).astype(np.int32)
    t_lens, u_lens = np.array([11, 7, 3], np.int32), np.array([4, 2, 0], np.int32)
    kw = dict(blank=V1 - 1, activation=activation, chunk_size=4)

    def jloss(f, g, w, b):
        return jax_rnnt_loss_fused(f, g, w, b, jnp.asarray(labels), jnp.asarray(t_lens),
                                   jnp.asarray(u_lens), **kw)

    want, wgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (f, g, w, b)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (f, g, w, b)]
    got = rnnt_loss_fused(*leaves, torch.from_numpy(labels), torch.from_numpy(t_lens),
                          torch.from_numpy(u_lens), **kw)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL, rtol=0)
    for a, gw in zip(torch.autograd.grad(got, leaves), wgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(gw), atol=ATOL, rtol=0)


def test_resolve_decoders_on_a_tanh_joint():
    cuda = torch.device("cuda")
    assert resolve_decoders("auto", "auto", cuda, 1, "tanh") == ("labelsync", "xla")
    assert resolve_decoders("auto", "auto", cuda, 1, "relu") == ("fused", "fused")
    port = HybridRNNTCTC(tiny_config(joint_activation="tanh"), device="cpu")
    tr = Transcriber(model=port, tokenizer=None, languages=["a"],
                     frontend=FrontendConfig(n_mels=32))
    assert (tr.greedy_impl, tr.beam_impl) == ("framesync", "xla")
    for impl in ("greedy_impl", "beam_impl"):
        with pytest.raises(ValueError, match="relu joint"):
            Transcriber(model=port, tokenizer=None, languages=["a"],
                        frontend=FrontendConfig(n_mels=32), **{impl: "fused"})


def _batch():
    rng = np.random.default_rng(4)
    B, S, U = 4, 8000, 6
    tokens = rng.integers(1, 16, (B, U)).astype(np.int32)
    return {
        "audio": (0.1 * rng.standard_normal((B, S))).astype(np.float32),
        "audio_len": np.array([S, S - 1500, S // 2, S // 2], np.int32),
        "tokens": tokens,
        "token_len": np.array([U, U - 2, U - 1, U - 1], np.int32),
        "lang_ids": np.array([0, 1, 2, 2], np.int32),
    }


def test_tanh_train_step_pallas_equals_xla():
    """The pallas joint is relu-only: with tanh the loss takes the chunked
    path, so the step equals the xla step exactly, and differs from a relu
    model's on the same weights (the activation reaches the loss)."""
    _, var_np, _ = pair(seed=1, joint_activation="tanh")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    losses, params = {}, {}
    for name, act, impl in (("pallas", "tanh", "pallas"), ("xla", "tanh", "xla"),
                            ("relu", "relu", "xla")):
        port = from_jax_variables(
            HybridRNNTCTC(tiny_config(joint_activation=act), device="cpu"), var_np)
        step_cfg = StepConfig(frontend=FrontendConfig(n_mels=32, dither=0.0),
                              use_spec_augment=False, rnnt_chunk_size=8, rnnt_impl=impl)
        opt = make_optimizer(port, lr=1e-3, device="cpu")
        aux = make_train_step(port, step_cfg, opt, device="cpu")(
            batch, torch.Generator().manual_seed(0))
        losses[name] = float(aux["train_loss"])
        params[name] = {n: p.detach().clone() for n, p in port.named_parameters()}
    assert losses["pallas"] == losses["xla"] != losses["relu"]
    for n, p in params["pallas"].items():
        assert torch.equal(p, params["xla"][n]), n
