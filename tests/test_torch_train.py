"""The port's train-mode DenseNet (ddl_tpu_torch/models/densenet.py)
against the JAX package's: logits and every updated running statistic vs
``forward_stages(..., train=True)``, and every parameter's gradient vs
``jax.grad``, for fused and packed dense blocks, with the JAX weights
carried across by models/convert.from_jax_params (the gradient tree too);
and the biased running-variance update."""

import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ddl_tpu.config import ModelConfig as JaxModelConfig
from ddl_tpu.models.densenet import build_stages, forward_stages, init_stages
from ddl_tpu.ops import cross_entropy_loss as jax_cross_entropy_loss
from ddl_tpu_torch.config import ModelConfig
from ddl_tpu_torch.models import DenseNet, from_jax_params
from ddl_tpu_torch.models.densenet import _bn_relu
from ddl_tpu_torch.ops import cross_entropy_loss

TINY = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16,
            bn_size=2, num_classes=5, dense_block_fused_blocks=(0, 3))
IMAGE, BATCH = 32, 8


def _randomize_stats(tree, rng):
    """Running stats off their 0/1 init, so the update's keep-rate shows."""
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.standard_normal(v.shape) * 0.3 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32), tree)


@functools.cache
def _both(impl):
    """(port model after one f32 train-mode forward and backward, its loss
    and logits; JAX's loss, logits, updated stats and gradients), on the
    same seeded images, labels and weights.  Cached: the forward and the
    gradient tests read one run."""
    cfg = JaxModelConfig(**TINY, dense_block_impl=impl, compute_dtype="float32", remat=False)
    stages = build_stages(cfg, num_stages=1)
    params, stats = jax.device_get(init_stages(stages, jax.random.key(0), IMAGE))
    stats = _randomize_stats(stats, np.random.default_rng(0))
    x = np.random.default_rng(1).uniform(0, 1, (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    y = np.random.default_rng(2).integers(0, 5, BATCH).astype(np.int32)

    def loss_fn(p):
        logits, new_stats = forward_stages(stages, p, stats, jnp.asarray(x), train=True)
        return jax_cross_entropy_loss(logits, jnp.asarray(y)), (logits, new_stats)

    (loss, (logits, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = DenseNet(ModelConfig(**TINY, dense_block_impl=impl, compute_dtype="float32"),
                     num_stages=1)
    model.load_state_dict(from_jax_params(params, stats))
    got_logits = model.train()(torch.from_numpy(x))
    got_loss = cross_entropy_loss(got_logits, torch.from_numpy(y))
    got_loss.backward()
    want = {"loss": float(loss), "logits": np.asarray(logits),
            "stats": from_jax_params(params, new_stats), "grads": from_jax_params(grads, stats)}
    return model, got_loss.item(), got_logits.detach().numpy(), want


# f32, where the point is the algorithm (the bf16 rounding points are the
# card's check, chip_smoke.py): the same arithmetic up to f32 rounding (the
# JAX stem, head and bottleneck norms normalise as (x - mean) * scale +
# bias, the port as one folded affine): logits and statistics to 1e-4 /
# 1e-5.
@pytest.mark.parametrize("impl", ["fused", "packed"])
def test_train_forward_matches_jax_f32(impl):
    model, loss, logits, want = _both(impl)
    np.testing.assert_allclose(logits, want["logits"], atol=1e-4, rtol=1e-4)
    assert loss == pytest.approx(want["loss"], rel=1e-5)
    sd = model.state_dict()
    keys = [k for k in want["stats"] if "running" in k]
    assert len(keys) == 2 * (1 + 4 * 2 * 2 + 3 + 1)  # norm0, 16 layer norms, 3 transitions, norm5
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want["stats"][k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


# Every parameter's gradient, f32, through the batch statistics (the fused
# blocks' stats pass and fold included).  Same math in another order: 1e-3
# of each leaf's largest value, plus 1e-4 of the model's largest gradient
# for leaves whose gradient cancels (the stem BN scale's largest gradient
# is ~5e-5 of the model's: the next layer normalises its scale away, so
# only f32 noise of that absolute size is left there).
@pytest.mark.parametrize("impl", ["fused", "packed"])
def test_train_gradients_match_jax(impl):
    model, _, _, want = _both(impl)
    named = dict(model.named_parameters())
    grads = {k: v for k, v in want["grads"].items() if k in named}
    assert grads.keys() == named.keys()
    big = max(np.abs(g.numpy()).max() for g in grads.values())
    for k, g in grads.items():
        g = g.numpy()
        err = np.abs(named[k].grad.numpy() - g).max()
        assert err <= 1e-3 * np.abs(g).max() + 1e-4 * big, k


def test_running_variance_update_is_biased():
    """ra = 0.9 * ra + 0.1 * batch with the biased batch variance, as Flax
    nn.BatchNorm (and the JAX package) do; F.batch_norm would use the
    unbiased one."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, 2, 2)).astype(np.float32) * 2 + 1
    bn = nn.BatchNorm2d(3)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.5, -0.5, 0.0]))
        bn.running_var.copy_(torch.tensor([2.0, 0.5, 1.0]))
    init_mean, init_var = bn.running_mean.clone(), bn.running_var.clone()
    _bn_relu(torch.from_numpy(x), bn.train(), torch.float32)
    biased = torch.from_numpy(x).var((0, 2, 3), unbiased=False)
    unbiased = torch.from_numpy(x).var((0, 2, 3), unbiased=True)
    torch.testing.assert_close(bn.running_var, 0.9 * init_var + 0.1 * biased)
    torch.testing.assert_close(bn.running_mean,
                               0.9 * init_mean + 0.1 * torch.from_numpy(x).mean((0, 2, 3)))
    assert not torch.allclose(bn.running_var, 0.9 * init_var + 0.1 * unbiased)

    flax_bn = flax_nn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.ones(3), "bias": jnp.zeros(3)},
                 "batch_stats": {"mean": jnp.asarray(init_mean.numpy()),
                                 "var": jnp.asarray(init_var.numpy())}}
    _, updated = flax_bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                               use_running_average=False, mutable=["batch_stats"])
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(updated["batch_stats"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(updated["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
