"""The port's partition rule tables (ddl_tpu_torch/parallel/rules.py)
against the JAX package's (ddl_tpu/parallel/rules.py), leaf for leaf, over
the same model's trees: the JAX init's parameter tree and the port's
``state_dict`` converted from it (``models/convert``), the LM and the ViT,
``fsdp`` off and on; every leaf must shard the same logical dimension over
the same axis (the ViT's patch kernel is torch's (O, I, kh, kw), JAX's
(kh, kw, I, O): its dimensions are compared through that permutation).
Adam's moments under ``strict=False`` (optax's ``mu``/``nu`` against the
port's ``exp_avg``/``exp_avg_sq`` named after their parameter), the
unmatched-leaf error, ZeRO's dimension and the per-device optimizer bytes
on a (data 2, model 2) mesh, and the model-axis cut and join of a snapshot
state (``shard_lm_state``/``gather_lm_state``, an odd vocabulary
included).  No world: pure accounting."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from ddl_tpu.parallel import rules as jax_rules
from ddl_tpu_torch.models.convert import (
    gather_lm_state,
    gather_vit_state,
    lm_params_from_jax,
    shard_lm_state,
    shard_vit_state,
    vit_params_from_jax,
)
from ddl_tpu_torch.models.transformer import LMConfig, TransformerLM, init_lm_weights
from ddl_tpu_torch.models.vit import ViT, ViTConfig, init_vit_weights
from ddl_tpu_torch.parallel import rules
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.state import Optimizer

LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
          compute_dtype="float32")
VIT = dict(image_size=16, patch_size=8, num_classes=5, d_model=32, n_layers=2, n_heads=4,
           head_dim=8, d_ff=64, compute_dtype="float32")
# the port's patch kernel dimension i is JAX's PERM[i]
PERM = {"patch_embed.weight": (3, 2, 0, 1)}
MESH = types.SimpleNamespace(shape={"data": 2, "model": 2})


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(nn.meta.unbox(tree)))


@functools.cache
def _jax_lm_params():
    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.models.transformer import TransformerLM as JaxTransformerLM

    model = JaxTransformerLM(JaxLMConfig(**LM))
    return _unbox(model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])


@functools.cache
def _jax_vit_params():
    from ddl_tpu.models.vit import ViT as JaxViT
    from ddl_tpu.models.vit import ViTConfig as JaxViTConfig

    model = JaxViT(JaxViTConfig(**VIT))
    return _unbox(model.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)))["params"])


def _jax_specs(table, tree, strict=True) -> dict:
    """``{"/"-joined path: spec entries padded to the leaf's rank}``."""
    specs = jax_rules.match_partition_rules(table, tree, strict=strict)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    out = {}
    for (kp, leaf), spec in zip(flat, spec_leaves):
        ndim = np.ndim(leaf)
        out[jax_rules.tree_path_str(kp)] = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return out


def _port_specs(table, tree, strict=True) -> dict:
    out = {}
    for name, leaf, spec, _ in rules.match_with_provenance(table, tree, strict=strict):
        ndim = leaf.dim() if isinstance(leaf, torch.Tensor) else np.ndim(leaf)
        out[name] = tuple(spec) + (None,) * (ndim - len(spec))
    return out


def _same_placement(port: dict, jax_by_name: dict) -> None:
    assert port.keys() == jax_by_name.keys()
    for name, got in port.items():
        want = jax_by_name[name]
        perm = PERM.get(name.split(".", 1)[-1] if name.startswith("exp_avg") else name)
        if perm is not None:
            want = tuple(want[j] for j in perm)
        assert got == want, (name, got, want)


FAMILIES = {
    "lm": (rules.lm_rules, jax_rules.lm_rules, _jax_lm_params, lm_params_from_jax),
    "vit": (rules.vit_rules, jax_rules.vit_rules, _jax_vit_params, vit_params_from_jax),
}


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tables_place_every_parameter_as_jax(family, fsdp):
    port_table, jax_table, params, convert = FAMILIES[family]
    tree = params()
    want = {k.replace("/", "."): v for k, v in _jax_specs(jax_table(fsdp), tree).items()}
    if family == "vit":
        want["patch_embed.weight"] = want.pop("patch_embed.kernel")
    _same_placement(_port_specs(port_table(fsdp), convert(tree)), want)


@pytest.mark.parametrize("family", ["cnn", "decode"])
def test_cnn_and_decode_tables_match_jax(family):
    tree = _jax_lm_params()
    want = {k.replace("/", "."): v
            for k, v in _jax_specs(getattr(jax_rules, f"{family}_rules")(), tree).items()}
    got = _port_specs(getattr(rules, f"{family}_rules")(), lm_params_from_jax(tree))
    _same_placement(got, want)


def _port_moments(model) -> dict:
    """The port's Adam state after one step as a flat tree whose moments
    embed their parameter's name (``exp_avg.<name>``, ``step.<name>``)."""
    opt = Optimizer(model.parameters(), 1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    state = opt.inner.state_dict()["state"]
    return {f"{k}.{name}": v for i, (name, _) in enumerate(model.named_parameters())
            for k, v in state.get(i, {}).items()}


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_adam_moments_take_their_parameters_placement(family, fsdp):
    """``strict=False`` over a whole optimizer state: the moments embed
    their parameter's name and match its rule; the counts replicate."""
    port_table, jax_table, params, convert = FAMILIES[family]
    tree = params()
    jax_state = optax.adam(1e-3).init(tree)
    want = _jax_specs(jax_table(fsdp), jax_state, strict=False)
    model = (TransformerLM(LMConfig(**LM)) if family == "lm" else ViT(ViTConfig(**VIT)))
    model.load_state_dict(convert(tree))
    got = _port_specs(port_table(fsdp), _port_moments(model), strict=False)
    by_name = {}
    for path, spec in want.items():
        parts = path.split("/")
        if len(parts) < 3 or parts[1] not in ("mu", "nu"):
            assert spec == (), path  # the count
            continue
        name = ".".join(parts[2:])
        if name == "patch_embed.kernel":
            name = "patch_embed.weight"
        by_name[f"{'exp_avg' if parts[1] == 'mu' else 'exp_avg_sq'}.{name}"] = spec
    for name, spec in list(got.items()):
        if name.startswith("step."):
            assert spec == (), name
            del got[name]
    _same_placement(got, by_name)


def test_an_unmatched_leaf_raises_unless_not_strict():
    tree = dict(_jax_lm_params(), extra={"kernel": np.zeros((3, 3), np.float32)})
    with pytest.raises(jax_rules.UnmatchedLeafError) as want:
        jax_rules.match_partition_rules(jax_rules.lm_rules(), tree)
    port_tree = lm_params_from_jax(tree)
    with pytest.raises(rules.UnmatchedLeafError) as got:
        rules.match_partition_rules(rules.lm_rules(), port_tree)
    assert got.value.paths == ["extra.kernel"] and want.value.paths == ["extra/kernel"]
    assert str(got.value) == str(want.value).replace("extra/kernel", "extra.kernel")
    specs = rules.match_partition_rules(rules.lm_rules(), port_tree, strict=False)
    assert specs["extra.kernel"] == rules.PartitionSpec()
    # a leaf of one element replicates without consulting the table
    assert rules.match_partition_rules(rules.lm_rules(), {"x.y": torch.zeros(1)}) == {
        "x.y": rules.PartitionSpec()}


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
def test_zero_dimension_and_optimizer_bytes_on_a_data_model_mesh(fsdp):
    """``zero_shard_spec``'s dimension and ``optimizer_hbm_bytes`` under the
    LM table at (data 2, model 2), the JAX accounting's numbers; and
    ``spec_axes``/``spec_num_shards``."""
    tree = _jax_lm_params()
    table, jtable = rules.lm_rules(fsdp), jax_rules.lm_rules(fsdp)
    jspecs = _jax_specs(jtable, tree)
    port = lm_params_from_jax(tree)
    pspecs = rules.match_partition_rules(table, port)
    for path, jspec in jspecs.items():
        name = path.replace("/", ".")
        shape = tuple(port[name].shape)
        z = jax_rules.zero_shard_spec(jax.sharding.PartitionSpec(*jspec), shape, MESH,
                                      threshold=64)
        got = rules.zero_shard_spec(shape, 2, 64, pspecs[name])
        assert (got is None) == (z is None), name
        if z is not None:
            assert tuple(z)[got] == "data", name
        assert rules.spec_axes(pspecs[name]) == jax_rules.spec_axes(
            jax.sharding.PartitionSpec(*jspec))
        assert rules.spec_num_shards(pspecs[name], MESH.shape) == jax_rules.spec_num_shards(
            jax.sharding.PartitionSpec(*jspec), MESH)
    want = jax_rules.optimizer_hbm_bytes(jtable, tree, MESH, threshold=64)
    got = rules.optimizer_hbm_bytes([tuple(v.shape) for v in port.values()], 2, 64,
                                    specs=list(pspecs.values()), mesh_shape=MESH.shape)
    assert got == want


@pytest.mark.parametrize("vocab", [64, 63], ids=["even", "odd"])
def test_lm_state_cut_and_join_over_model(vocab):
    """A one-device snapshot state (the model and Adam's moments) cut into
    two model ranks' parts under ``lm_rules`` and joined back, bit-equal;
    an odd vocabulary pads the last shard with zero rows."""
    model = TransformerLM(LMConfig(**dict(LM, vocab_size=vocab)))
    init_lm_weights(model, 0)
    opt = Optimizer(model.parameters(), 1e-3)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(), "step": 1}
    spec = LMMeshSpec(model=2)
    parts = [shard_lm_state(state, spec, m) for m in range(2)]
    assert parts[0]["model"]["block0.attn.q.kernel"].shape == (32, 16)
    assert parts[1]["model"]["embed.embedding"].shape == (32, 32)
    if vocab == 63:
        assert parts[1]["model"]["lm_head.kernel"][-1].abs().max() == 0
    back = gather_lm_state(parts, vocab_size=vocab)
    assert back["step"] == 1
    for k, v in state["model"].items():
        assert torch.equal(back["model"][k], v), k
    for i, st in state["optimizer"]["inner"]["state"].items():
        for name, v in st.items():
            assert torch.equal(back["optimizer"]["inner"]["state"][i][name], v), (i, name)


def test_vit_state_cut_and_join_over_model():
    model = ViT(ViTConfig(**VIT))
    init_vit_weights(model, 0)
    state = {"model": model.state_dict(), "step": 0}
    parts = [shard_vit_state(state, LMMeshSpec(model=2), m) for m in range(2)]
    assert parts[1]["model"]["block0.mlp.wo.kernel"].shape == (32, 32)
    assert torch.equal(parts[1]["model"]["patch_embed.weight"], state["model"][
        "patch_embed.weight"])
    back = gather_vit_state(parts)
    assert all(torch.equal(back["model"][k], v) for k, v in state["model"].items())
