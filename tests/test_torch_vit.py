"""The port's ViT (ddl_tpu_torch/models/vit.py, train/vit_steps.py) against
the JAX package's on one CPU device: the same weights (carried across by
``models/convert.vit_params_from_jax``) and the same seeded uint8 batch.
The forward's logits, MHA and GQA; one AdamW step and one at
``accum_steps=2`` against ``make_vit_step_fns(cfg, LMMeshSpec(), ...)``;
the converter's round trip; every refusal of the step factory, with the
JAX factory's messages.

f32 on both sides, the same math in another summation order: the logits
1e-5 of the largest, the loss 1e-5 relative and every parameter after the
step 1e-4 of the largest (the JAX ViT tests' limits)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from ddl_tpu.models.vit import ViT as JaxViT
from ddl_tpu.models.vit import ViTConfig as JaxViTConfig
from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
from ddl_tpu.train.vit_steps import make_vit_step_fns as jax_make_vit_step_fns
from ddl_tpu_torch.models.convert import vit_params_from_jax, vit_params_to_jax
from ddl_tpu_torch.models.vit import ViT, ViTConfig, init_vit_weights
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.state import Optimizer
from ddl_tpu_torch.train.vit_steps import make_vit_step_fns

TINY = dict(image_size=32, patch_size=8, num_classes=5, d_model=64, n_layers=2, n_heads=4,
            head_dim=16, d_ff=128, compute_dtype="float32")
BATCH, LR = 8, 1e-3
LOGIT_TOL, LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5, 1e-4


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 5, BATCH).astype(np.int32)
    return images, labels


def _adamw(params):
    """optax.adamw(LR): decoupled weight decay 1e-4 (optax's default)."""
    return Optimizer(params, LR, weight_decay=1e-4)


def _rel_err(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    return max(float(np.abs(got[k].numpy() - want[k].numpy()).max()) for k in want) / scale


@functools.cache
def _jax_params(kv_heads: int = 0) -> dict:
    model = JaxViT(JaxViTConfig(**TINY, n_kv_heads=kv_heads))
    params = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(nn.meta.unbox(params)))


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_forward_logits_match_jax(kv_heads):
    params = _jax_params(kv_heads)
    images, _ = _batch()
    x = images.astype(np.float32) / 255.0
    want = np.asarray(JaxViT(JaxViTConfig(**TINY, n_kv_heads=kv_heads)).apply(
        {"params": params}, jnp.asarray(x)))
    model = ViT(ViTConfig(**TINY, n_kv_heads=kv_heads))
    model.load_state_dict(vit_params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (BATCH, 5)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


@functools.cache
def _jax_step(accum_steps: int):
    """(initial params, loss, params after one optax.adamw step)."""
    fns = jax_make_vit_step_fns(JaxViTConfig(**TINY), JaxMeshSpec(), optax.adamw(LR),
                                jax.random.key(0), BATCH, devices=jax.devices()[:1],
                                accum_steps=accum_steps)
    state = fns.init_state()
    params0 = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    images, labels = _batch()
    state, m = fns.train(state, jnp.asarray(images), jnp.asarray(labels))
    return params0, float(m["loss"]), jax.tree_util.tree_map(np.asarray,
                                                             jax.device_get(state.params))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_one_adamw_step_matches_jax(accum_steps):
    params0, want_loss, want_params = _jax_step(accum_steps)
    fns = make_vit_step_fns(ViTConfig(**TINY), LMMeshSpec(), _adamw, 0, BATCH, device="cpu",
                            accum_steps=accum_steps)
    state = fns.init_state()
    state.model.load_state_dict(vit_params_from_jax(params0))
    images, labels = _batch()
    state, m = fns.train(state, torch.from_numpy(images), torch.from_numpy(labels).long())
    assert state.step == 1
    np.testing.assert_allclose(m["loss"].item(), want_loss, rtol=LOSS_RTOL)
    assert 0.0 <= m["accuracy"].item() <= 1.0
    assert _rel_err(state.model.state_dict(), vit_params_from_jax(want_params)) <= PARAM_TOL


def test_converter_round_trip_is_exact():
    params = _jax_params()
    back = vit_params_to_jax(vit_params_from_jax(params))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    model = ViT(ViTConfig(**TINY))
    init_vit_weights(model, 5)
    sd = model.state_dict()
    again = vit_params_from_jax(vit_params_to_jax(sd))
    assert all(torch.equal(again[k], v) for k, v in sd.items())


def test_init_draws_the_flax_distributions():
    """Seeded init: zero biases, unit norm scales, pos_embed ~ N(0, 0.02),
    the patch kernel lecun_normal over its fan-in (std sqrt(1/192))."""
    cfg = ViTConfig(image_size=224, patch_size=16, d_model=384, n_layers=1, n_heads=6,
                    compute_dtype="float32")
    model = ViT(cfg)
    init_vit_weights(model, 0)
    assert model.patch_embed.bias.abs().max() == 0 and model.head.bias.abs().max() == 0
    assert torch.equal(model.norm_f.scale, torch.ones(384))
    assert abs(model.pos_embed.std().item() - 0.02) < 2e-3
    assert abs(model.patch_embed.weight.std().item() - (1 / 768) ** 0.5) < 2e-3
    other = ViT(cfg)
    init_vit_weights(other, 0)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), other.parameters()))


# (kwargs of both factories) -> the refusal; the JAX factory raises first
# with the same arguments and its message is the one the port must give
REFUSALS = {
    "seq": dict(spec=dict(seq=2)),
    "expert": dict(spec=dict(expert=2)),
    "accum0": dict(accum_steps=0),
    "schedule": dict(pipeline_schedule="zz"),
    "flat_schedule": dict(pipeline_schedule="1f1b"),
    "flat_virtual": dict(virtual_stages=2),
    "flat_microbatches": dict(num_microbatches=2),
    "flat_accum_split": dict(accum_steps=3),
    "flat_batch_data": dict(spec=dict(data=3)),
    "pipe_accum": dict(spec=dict(pipe=2), accum_steps=2),
    "pipe_zero": dict(spec=dict(pipe=2), zero_sharding=True),
    "pipe_virtual0": dict(spec=dict(pipe=2), virtual_stages=0),
    "pipe_zb_virtual": dict(spec=dict(pipe=2), pipeline_schedule="zb", virtual_stages=2),
    "pipe_groups": dict(spec=dict(pipe=2), num_microbatches=3, virtual_stages=2),
    "pipe_layers": dict(spec=dict(pipe=2), virtual_stages=2, num_microbatches=2),
    "pipe_batch": dict(spec=dict(pipe=2), num_microbatches=3),
    "pipe_microbatch_data": dict(spec=dict(pipe=2, data=2), num_microbatches=2, batch=6),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_step_factory_refusals_are_jax_s(name):
    kw = dict(REFUSALS[name])
    spec = kw.pop("spec", {})
    batch = kw.pop("batch", BATCH)
    with pytest.raises(ValueError) as want:
        jax_make_vit_step_fns(JaxViTConfig(**TINY), JaxMeshSpec(**spec), optax.adam(LR),
                              jax.random.key(0), batch, **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        make_vit_step_fns(ViTConfig(**TINY), LMMeshSpec(**spec), _adamw, 0, batch,
                          device="cpu", **kw)


def test_tensor_parallelism_is_item_11():
    """The ``model`` axis is taken (tests/test_torch_lm_tensor.py runs it
    against JAX): past the checks, the factory needs a world of two ranks;
    FSDP over ``data`` (item 11b) and a head count ``model`` does not
    divide are refused before that."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_vit_step_fns(ViTConfig(**TINY), LMMeshSpec(model=2), _adamw, 0, BATCH,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="item 11b"):
        make_vit_step_fns(ViTConfig(**TINY, fsdp=True), LMMeshSpec(data=2), _adamw, 0, BATCH,
                          device="cpu")
    with pytest.raises(ValueError, match="d_ff 128 must divide by mesh model=3"):
        make_vit_step_fns(ViTConfig(**{**TINY, "n_heads": 6, "n_kv_heads": 3}),
                          LMMeshSpec(model=3), _adamw, 0, BATCH, device="cpu")
    # on one data rank fsdp shards nothing and is a no-op, as in JAX
    fns = make_vit_step_fns(ViTConfig(**TINY, fsdp=True), LMMeshSpec(), _adamw, 0, BATCH,
                            device="cpu")
    assert fns.init_state().step == 0


def test_zero_refuses_weight_decay_and_clipping():
    """ZeRO-1 takes the plain fused Adam, as the JAX example's --zero does;
    at data 1 it is the replicated step (JAX's with_zero at data 1)."""
    from ddl_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from ddl_tpu_torch.train.fused_optim import with_zero

    model = ViT(ViTConfig(**TINY))
    with pytest.raises(ValueError, match="fused Adam"):
        with_zero(_adamw(model.parameters()), Mesh(MeshSpec(2, 1), torch.device("cpu")))
    fns = make_vit_step_fns(ViTConfig(**TINY), LMMeshSpec(), _adamw, 0, BATCH, device="cpu",
                            zero_sharding=True)
    assert fns.init_state().optimizer.zero is None


def test_the_default_device_is_cuda():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_vit_step_fns(ViTConfig(**TINY), LMMeshSpec(), _adamw, 0, BATCH)


def test_bench_runs_on_the_cpu():
    """``bench.vit``'s JSON line at a tiny size on the CPU (its times mean
    nothing there; the card's are in PERF.md)."""
    from ddl_tpu_torch.bench import vit as bench_vit

    out = bench_vit.main(["--device", "cpu", "--batch", "4", "--image-size", "32", "--patch",
                          "8", "--d-model", "64", "--layers", "2", "--iters", "1",
                          "--windows", "2"])
    assert len(out["ms_windows"]) == 2 and out["ms_per_step"] > 0
    assert np.isfinite(out["loss"]) and out["device"] == "cpu" and out["remat"] == "full"
