"""The port's DenseNet (ddl_tpu_torch/models/) against the JAX package's,
with the JAX weights carried across by models/convert.from_jax_params:
eval logits with fused and packed dense blocks in f32 and bf16, the
torchvision key names, and exact weight round trips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.config import ModelConfig as JaxModelConfig
from ddl_tpu.models.densenet import build_stages, forward_stages, init_stages
from ddl_tpu_torch.config import ModelConfig
from ddl_tpu_torch.models import (
    DenseNet,
    build_stage_specs,
    from_jax_params,
    init_weights,
    to_jax_params,
)

TINY = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16,
            bn_size=2, num_classes=5, dense_block_fused_blocks=(0, 3),
            pallas_normalize=True)
IMAGE = 64
_BN_KEYS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _randomize_stats(tree, rng):
    """Running stats as a trained model has them: means off zero, positive
    variances off one (a fresh init's 0/1 would hide a wrong fold)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_stats(v, rng)
        elif k == "mean":
            out[k] = (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def _jax_model(impl, dtype, split_blocks=(2,), num_stages=1):
    cfg = JaxModelConfig(**TINY, dense_block_impl=impl, compute_dtype=dtype,
                         split_blocks=split_blocks, remat=False)
    stages = build_stages(cfg, num_stages=num_stages)
    params, stats = jax.device_get(init_stages(stages, jax.random.key(0), IMAGE))
    rng = np.random.default_rng(0)
    stats = tuple(_randomize_stats(s, rng) for s in stats)
    return stages, params, stats


def _logits(impl, dtype):
    """(port logits, JAX logits) on the same seeded images and weights."""
    stages, params, stats = _jax_model(impl, dtype)
    x = np.random.default_rng(1).uniform(0, 1, (8, IMAGE, IMAGE, 3)).astype(np.float32)
    want, _ = forward_stages(stages, params, stats, jnp.asarray(x), train=False)
    model = DenseNet(ModelConfig(**TINY, dense_block_impl=impl, compute_dtype=dtype),
                     num_stages=1)
    model.load_state_dict(from_jax_params(params, stats))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("impl", ["fused", "packed"])
def test_eval_logits_match_jax_f32(impl):
    got, want = _logits(impl, "float32")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# bf16: the two packages round to bf16 at different points (the JAX packed
# blocks and transitions sum their per-pack 1x1 partial products in bf16,
# the port's convs accumulate in f32), so the logits agree to a few bf16
# ulps of the largest logit (one ulp is 2^-8 to 2^-7 of it): 2e-2 of it,
# with the same argmax.
@pytest.mark.parametrize("impl", ["fused", "packed"])
def test_eval_logits_match_jax_bf16(impl):
    got, want = _logits(impl, "bfloat16")
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_state_dict_keys_follow_torchvision():
    cfg = ModelConfig(**TINY)
    keys = ["features.conv0.weight"] + [f"features.norm0.{k}" for k in _BN_KEYS]
    for b, n_layers in enumerate(cfg.block_config):
        for i in range(n_layers):
            p = f"features.denseblock{b + 1}.denselayer{i + 1}"
            keys += [f"{p}.norm1.{k}" for k in _BN_KEYS] + [f"{p}.conv1.weight"]
            keys += [f"{p}.norm2.{k}" for k in _BN_KEYS] + [f"{p}.conv2.weight"]
        if b < len(cfg.block_config) - 1:
            keys += [f"features.transition{b + 1}.norm.{k}" for k in _BN_KEYS]
            keys += [f"features.transition{b + 1}.conv.weight"]
    keys += [f"features.norm5.{k}" for k in _BN_KEYS]
    keys += ["classifier.weight", "classifier.bias"]
    sd = DenseNet(cfg).state_dict()
    assert list(sd) == keys
    assert tuple(sd["features.denseblock1.denselayer2.conv1.weight"].shape) == (16, 24, 1, 1)
    assert tuple(sd["features.denseblock1.denselayer2.conv2.weight"].shape) == (8, 16, 3, 3)


def test_weights_round_trip_exactly():
    """JAX trees -> state_dict -> JAX trees, two stages split at block 3,
    and state_dict -> JAX trees -> state_dict, both bit-exact."""
    _, params, stats = _jax_model("fused", "float32", split_blocks=(2,), num_stages=None)
    assert len(params) == 2
    sd = from_jax_params(params, stats)
    specs = build_stage_specs(ModelConfig(**TINY, split_blocks=(2,)))
    back_params, back_stats = to_jax_params(sd, specs)
    for want, got in ((params, back_params), (stats, back_stats)):
        w, g = jax.tree_util.tree_flatten_with_path(want), jax.tree_util.tree_flatten_with_path(got)
        assert w[1] == g[1]
        for (path, a), (_, b) in zip(w[0], g[0]):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    sd_again = from_jax_params(back_params, back_stats)
    assert list(sd_again) == list(sd)
    for k, v in sd.items():
        torch.testing.assert_close(sd_again[k], v, rtol=0, atol=0)


def test_init_is_seeded():
    cfg = ModelConfig(**TINY)
    a, b, c = DenseNet(cfg), DenseNet(cfg), DenseNet(cfg)
    init_weights(a, 7)
    init_weights(b, 7)
    init_weights(c, 8)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    assert not torch.equal(a.state_dict()["features.conv0.weight"],
                           c.state_dict()["features.conv0.weight"])
