"""The port's transformer LM (ddl_tpu_torch/models/transformer.py) against
the JAX package's Flax model on the same weights (carried over by
``models/convert.lm_params_from_jax``): the config, RMSNorm, rope with
(T,) and (B, T) positions, and ``TransformerLM`` logits (MHA, GQA, sliding
window) in f32 to 1e-5 and in bf16 within a stated tolerance; the
converter's round trip; the port's own init distributions."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.models import transformer as jt
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.models.convert import lm_params_from_jax, lm_params_to_jax

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
             compute_dtype="float32")
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}, "window": {"attn_window": 3}}


def jax_params(cfg_kw, seed=0, t=8):
    cfg = jt.LMConfig(**cfg_kw, remat=False)
    params = jt.TransformerLM(cfg, None).init(jax.random.key(seed), jnp.zeros((1, t), jnp.int32))
    return cfg, jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params["params"]))


def port_model(cfg_kw, tree):
    model = tt.TransformerLM(tt.LMConfig(**cfg_kw))
    model.load_state_dict(lm_params_from_jax(tree))
    return model.eval()


def test_config_fields_defaults_and_checks_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(tt.LMConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jt.LMConfig)}
    assert ours == theirs
    assert tt.LMConfig(n_heads=12, n_kv_heads=4).kv_heads == 4
    assert tt.LMConfig().dtype == torch.bfloat16
    for bad in (dict(n_heads=4, n_kv_heads=3), dict(attn_window=-1),
                dict(attn_window=4, causal=False), dict(moe_ep="x"),
                dict(ce_chunk=4, ce_vocab_chunk=4), dict(ce_chunk=-1)):
        with pytest.raises(ValueError):
            jt.LMConfig(**bad)
        with pytest.raises(ValueError):
            tt.LMConfig(**bad)
    assert tt.LMConfig(num_experts=4).num_experts == 4  # mixture-of-experts is ported
    for mod in (jt, tt):
        with pytest.raises(ValueError, match="capacity_factor_min"):
            mod.LMConfig(num_experts=4, capacity_factor_min=0)


def test_rmsnorm_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 32)).astype(np.float32) * 3
    scale = np.random.default_rng(1).uniform(0.5, 1.5, 32).astype(np.float32)
    want = jt.RMSNorm(jnp.float32).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = tt.RMSNorm(32, torch.float32)
    norm.scale.data = torch.from_numpy(scale)
    np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("positions", ["default", "shared", "per-row"])
def test_rope_matches_jax(positions):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = {"default": None, "shared": np.arange(40, 46),
           "per-row": np.stack([np.arange(3, 9), np.arange(100, 106)])}[positions]
    want = jt._rope(jnp.asarray(x), 10000.0, None if pos is None else jnp.asarray(pos))
    got = tt._rope(torch.from_numpy(x), 10000.0, None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_lm_logits_match_jax_f32(variant):
    kw = {**SMALL, **VARIANTS[variant]}
    cfg, tree = jax_params(kw)
    tokens = np.random.default_rng(3).integers(0, 64, (2, 9))
    want, _ = jt.TransformerLM(cfg, None).apply({"params": tree}, jnp.asarray(tokens))
    got, aux = port_model(kw, tree)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_lm_logits_match_jax_bf16():
    """bf16 compute: the same rounding points, but the two frameworks' bf16
    products, GELU and rope round at places of their own; the logits stay
    within 2e-2 of the largest |logit| over two layers."""
    kw = {**SMALL, "compute_dtype": "bfloat16", "n_kv_heads": 2}
    cfg, tree = jax_params(kw)
    tokens = np.random.default_rng(4).integers(0, 64, (2, 9))
    want = np.asarray(jt.TransformerLM(cfg, None).apply({"params": tree}, jnp.asarray(tokens))[0])
    got = port_model(kw, tree)(torch.from_numpy(tokens))[0].detach().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_final_norm_and_head_match_jax():
    kw = {**SMALL}
    cfg, tree = jax_params(kw)

    class NormAndHead(nn.Module):
        @nn.compact
        def __call__(self, x):
            return jt.apply_final_norm_and_head(cfg, x)

    x = np.random.default_rng(5).standard_normal((2, 5, 32)).astype(np.float32) * 2
    want = NormAndHead().apply(
        {"params": {"norm_f": tree["norm_f"], "lm_head": tree["lm_head"]}}, jnp.asarray(x))
    got = tt.apply_final_norm_and_head(port_model(kw, tree), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_converter_round_trip_is_exact_and_names_match():
    kw = {**SMALL, "n_kv_heads": 2}
    _, tree = jax_params(kw, seed=7)
    sd = lm_params_from_jax(tree)
    model = tt.TransformerLM(tt.LMConfig(**kw))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    back = lm_params_to_jax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert tt.count_lm_params(sd) == tt.count_lm_params(model) == sum(
        int(x.size) for x in jax.tree_util.tree_leaves(tree))


def test_init_follows_flax_distributions():
    """lecun_normal: truncated at 2 sigma with std sqrt(1/fan_in) overall;
    the head's fan-in is d_model; embedding normal(0.02); norms ones."""
    cfg = tt.LMConfig(vocab_size=512, d_model=256, n_layers=1, n_heads=4, head_dim=64, d_ff=1024)
    model = tt.TransformerLM(cfg)
    tt.init_lm_weights(model, 0)
    for w, fan_in in ((model.block0.mlp.wi.kernel, 256), (model.block0.mlp.wo.kernel, 1024),
                      (model.lm_head.kernel, 256)):
        target = (1.0 / fan_in) ** 0.5
        assert abs(w.std().item() / target - 1) < 0.03
        assert w.abs().max().item() <= 2 * target / 0.87962566103423978 + 1e-6
    assert abs(model.embed.embedding.std().item() / 0.02 - 1) < 0.03
    assert (model.norm_f.scale == 1).all() and (model.block0.norm_attn.scale == 1).all()
    again = tt.TransformerLM(cfg)
    tt.init_lm_weights(again, 0)
    torch.testing.assert_close(again.state_dict(), model.state_dict(), rtol=0, atol=0)
