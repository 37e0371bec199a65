"""Port parity: the PyTorch HybridRNNTCTC loaded with the JAX package's
variables (``from_jax_variables``) against the Flax model, at
``tiny_config()`` in f32 on the CPU.

Both encoder parameter layouts (scanned ``stack/layers`` and unrolled
``layers_i``) load, with random non-trivial BatchNorm statistics.
Tolerance: atol 1e-4 on encoder outputs, projections, CTC log-probs and
joint logits (f32 sums in another order; measured ~2e-6).

``attention_route``: a flash config above head dim 128 runs the eager
attention, resolved at construction; at d_model 512 in 2 heads (D 256)
the port's encoder matches the JAX encoder, whose module takes its flash
kernel there (the Pallas kernel in interpret mode on the CPU), to the same
atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indic_cl_asr_tpu.models.hybrid import init_model
from indic_cl_asr_tpu.models.hybrid import tiny_config as jax_tiny_config
from indic_cl_asr_torch.models.conformer import attention_route
from indic_cl_asr_torch.models.convert import from_jax_variables
from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, tiny_config

ATOL = 1e-4


def _with_random_stats(variables, rng):
    """numpy copy of the variables with random BatchNorm mean/var."""

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "var":
                out[k] = (0.5 + np.abs(rng.standard_normal(v.shape))).astype(np.float32)
            else:
                out[k] = (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        return out

    var_np = jax.tree.map(np.asarray, variables)
    return {"params": var_np["params"], "batch_stats": fill(var_np["batch_stats"])}


def jax_and_port(seed=0, scan=False, attn_impl="xla", **overrides):
    """(flax module, jax variables, port model) sharing one set of weights."""
    jcfg = jax_tiny_config(**overrides)
    jcfg = dataclasses.replace(
        jcfg, encoder=dataclasses.replace(jcfg.encoder, scan_layers=scan)
    )
    model, variables = init_model(jcfg, jax.random.PRNGKey(seed))
    var_np = _with_random_stats(variables, np.random.default_rng(seed))
    pcfg = tiny_config(**overrides)
    pcfg = dataclasses.replace(
        pcfg, encoder=dataclasses.replace(pcfg.encoder, attn_impl=attn_impl)
    )
    port = from_jax_variables(HybridRNNTCTC(pcfg, device="cpu"), var_np)
    return model, jax.tree.map(jnp.asarray, var_np), port


def _feats(seed=0, B=2, T=64):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, 32, T)).astype(np.float32)
    lens = np.array([T, 37][:B], np.int32)
    return feats, lens


@pytest.mark.parametrize("scan", [False, True])
def test_heads_and_encoder_match_jax(scan):
    model, jv, port = jax_and_port(seed=1, scan=scan)
    feats, lens = _feats(1)
    f_j, l_j = model.apply(jv, jnp.asarray(feats), jnp.asarray(lens), False,
                           method="encode")
    f_t, l_t = port.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(np.asarray(l_j), l_t.numpy())
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=ATOL)

    lang = np.array([1, 3], np.int32)
    c_j = model.apply(jv, f_j, jnp.asarray(lang), method="ctc_logprobs")
    c_t = port.ctc_logprobs(f_t, torch.from_numpy(lang))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL)

    p_j = model.apply(jv, f_j, method="joint_project_enc")
    p_t = port.joint_project_enc(f_t)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=ATOL)

    # two prediction steps (blank SOS, then a real label) and the joint
    blank = port.cfg.blank_local
    state_j = state_t = None
    for lab in (np.array([blank, blank], np.int32), np.array([3, 15], np.int32)):
        g_j, state_j = model.apply(jv, jnp.asarray(lab), state_j, method="pred_step")
        g_t, state_t = port.pred_step(torch.from_numpy(lab), state_t)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL)
        j_j = model.apply(jv, p_j[:, 3], g_j, jnp.asarray(lang), method="joint_step")
        j_t = port.joint_step(p_t[:, 3], g_t, torch.from_numpy(lang))
        np.testing.assert_allclose(j_t.numpy(), np.asarray(j_j), atol=ATOL)


@pytest.mark.parametrize("band", [(-1, -1), (4, 2)])
def test_flash_encoder_matches_xla_encoder(band):
    """attn_impl='flash' (the kernel wrapper, plain version on the CPU)
    gives the eager attention path's encoder output."""
    cfg = tiny_config()
    enc = dataclasses.replace(cfg.encoder, att_context_size=band)
    port_x = HybridRNNTCTC(dataclasses.replace(cfg, encoder=enc), device="cpu")
    port_f = HybridRNNTCTC(
        dataclasses.replace(cfg, encoder=dataclasses.replace(enc, attn_impl="flash")),
        device="cpu",
    )
    torch.manual_seed(0)
    for p in port_x.parameters():
        p.copy_(torch.randn_like(p) * 0.2)
    port_f.load_state_dict(port_x.state_dict())
    feats, lens = _feats(3)
    out_x, _ = port_x.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    out_f, _ = port_f.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(out_f.numpy(), out_x.numpy(), atol=ATOL)


def test_banded_encoder_matches_jax():
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(
        jcfg, encoder=dataclasses.replace(jcfg.encoder, att_context_size=(4, 2))
    )
    model, variables = init_model(jcfg, jax.random.PRNGKey(4))
    var_np = _with_random_stats(variables, np.random.default_rng(4))
    pcfg = tiny_config()
    pcfg = dataclasses.replace(
        pcfg, encoder=dataclasses.replace(pcfg.encoder, att_context_size=(4, 2))
    )
    port = from_jax_variables(HybridRNNTCTC(pcfg, device="cpu"), var_np)
    feats, lens = _feats(4)
    f_j, _ = model.apply(jax.tree.map(jnp.asarray, var_np), jnp.asarray(feats),
                         jnp.asarray(lens), False, method="encode")
    f_t, _ = port.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=ATOL)


def test_eval_only_and_layout_errors():
    port = HybridRNNTCTC(tiny_config(), device="cpu")
    with pytest.raises(TypeError):  # one layer layout: no scan_layers option
        dataclasses.replace(port.cfg.encoder, scan_layers=True)
    assert not port.training  # built for serving
    port.train()
    assert all(m.training for m in port.modules())
    port.eval()
    bad = {"params": {"encoder": {"pre_encode": {}}}}
    with pytest.raises(KeyError):
        from_jax_variables(port, bad)


@pytest.mark.parametrize("d_model,n_heads,impl,route", [
    (512, 8, "flash", "flash"), (512, 4, "flash", "flash"), (128, 1, "flash", "flash"),
    (512, 2, "flash", "xla"), (256, 1, "flash", "xla"), (512, 2, "xla", "xla"),
    (512, 8, "xla", "xla"),
])
def test_attention_route_follows_the_head_dim(d_model, n_heads, impl, route):
    """D 64 and 128 keep the flash kernels; D 256 takes the eager path;
    the route is a function of the config alone, shown by the encoder."""
    enc = dataclasses.replace(tiny_config().encoder, d_model=d_model, n_heads=n_heads,
                              attn_impl=impl)
    assert attention_route(enc) == route
    port = HybridRNNTCTC(dataclasses.replace(tiny_config(), encoder=enc), device="cpu")
    assert port.encoder.attention_route == route
    assert f"attention_route={route!r}" in repr(port.encoder)
    assert {layer.self_attn.route for layer in port.encoder.layers} == {route}


def test_head_dim_256_flash_encoder_matches_jax(monkeypatch):
    """d_model 512 in 2 heads with attn_impl="flash": the JAX module runs
    its flash kernel, the port its eager attention (the flash wrapper is
    never called); atol 1e-4."""
    import indic_cl_asr_torch.models.conformer as conformer

    def no_flash(*a, **kw):
        raise AssertionError("the D-256 encoder called the flash wrapper")

    monkeypatch.setattr(conformer, "flash_relpos_mhsa", no_flash)
    over = dict(d_model=512, n_heads=2)
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(
        jcfg, encoder=dataclasses.replace(jcfg.encoder, attn_impl="flash", **over))
    model, variables = init_model(jcfg, jax.random.PRNGKey(5))
    var_np = _with_random_stats(variables, np.random.default_rng(5))
    pcfg = tiny_config()
    pcfg = dataclasses.replace(
        pcfg, encoder=dataclasses.replace(pcfg.encoder, attn_impl="flash", **over))
    port = from_jax_variables(HybridRNNTCTC(pcfg, device="cpu"), var_np)
    assert port.encoder.attention_route == "xla"
    feats, lens = _feats(5, T=48)
    f_j, l_j = model.apply(jax.tree.map(jnp.asarray, var_np), jnp.asarray(feats),
                           jnp.asarray(lens), False, method="encode")
    f_t, l_t = port.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(np.asarray(l_j), l_t.numpy())
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=ATOL)
