"""The port's optimizer (ddl_tpu_torch/train/state.py) against the JAX
package's optax transformations: five updates on the same fixed gradients
for plain Adam, the fused Adam, AdamW, global-norm clipping, and
warmup + cosine, plus the optax schedule count (a warmup's first step at
learning rate 0)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl_tpu.config import TrainConfig as JaxTrainConfig
from ddl_tpu.train.state import build_optimizer as jax_build_optimizer
from ddl_tpu.train.state import make_optimizer as jax_make_optimizer
from ddl_tpu_torch.config import TrainConfig
from ddl_tpu_torch.train import Optimizer, make_optimizer

SHAPES = {"w": (6, 4), "b": (4,), "s": (3, 2, 2)}
STEPS = 5

CASES = {
    "adam": dict(),
    "fused_adam": dict(fused=True),
    "adamw": dict(weight_decay=0.05),
    "clip": dict(grad_clip_norm=1.0),
    "warmup_cosine": dict(lr_schedule="cosine", warmup_steps=2, decay_steps=4),
    "constant_warmup": dict(warmup_steps=3),
}


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    # gradients of varied size per step, so clipping triggers on some steps only
    grads = [{k: (rng.standard_normal(s) * (0.1 + t % 3)).astype(np.float32)
              for k, s in SHAPES.items()} for t in range(STEPS)]
    return params, grads


def _jax_trajectory(tx, params, grads):
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(params)
    out = []
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


def _port_trajectory(make, params, grads):
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make(tensors.values())
    out = []
    for g in grads:
        opt.zero_grad()
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        out.append({k: p.detach().numpy().copy() for k, p in tensors.items()})
    return out


# The same update in f32 in another order: 1e-6 absolute, a few f32 ulps of
# parameters of size ~1-4 (a step moves one by about lr).
@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    kw = CASES[case]
    params, grads = _problem()
    want = _jax_trajectory(jax_build_optimizer(1e-2, **kw), params, grads)
    got = _port_trajectory(lambda p: Optimizer(p, 1e-2, **kw), params, grads)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6,
                                       err_msg=f"{case} step {step + 1} {k}")


def test_make_optimizer_matches_jax_defaults():
    """TrainConfig defaults on both sides: the reference's unconfigured
    Adam (lr 1e-3), fused in JAX."""
    params, grads = _problem(1)
    want = _jax_trajectory(jax_make_optimizer(JaxTrainConfig()), params, grads)
    got = _port_trajectory(lambda p: make_optimizer(p, TrainConfig()), params, grads)
    for g, w in zip(got, want):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)


def test_warmup_takes_its_first_step_at_lr_zero():
    """optax evaluates the schedule at the count before the update."""
    params, grads = _problem(2)
    got = _port_trajectory(lambda p: Optimizer(p, 1e-2, warmup_steps=4), params, grads)
    for k in SHAPES:
        np.testing.assert_array_equal(got[0][k], params[k])
        assert not np.array_equal(got[1][k], params[k])


@pytest.mark.parametrize("kw,match", [
    (dict(lr_schedule="cosine"), "decay_steps > 0"),
    (dict(lr_schedule="cosine", warmup_steps=5, decay_steps=5), "must exceed"),
    (dict(lr_schedule="linear"), "unknown lr_schedule"),
])
def test_bad_schedules_are_refused_as_in_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        jax_build_optimizer(1e-3, **kw)
    with pytest.raises(ValueError, match=match):
        Optimizer([torch.nn.Parameter(torch.zeros(1))], 1e-3, **kw)


def test_clipping_leaves_small_gradients_alone():
    """Below the threshold the update is exactly unclipped Adam's."""
    params, grads = _problem(3)
    grads = [{k: v * 1e-3 for k, v in g.items()} for g in grads]
    clipped = _port_trajectory(lambda p: Optimizer(p, 1e-2, grad_clip_norm=1e3),
                               params, grads)
    plain = _port_trajectory(lambda p: Optimizer(p, 1e-2), params, grads)
    for g, w in zip(clipped, plain):
        for k in SHAPES:
            np.testing.assert_array_equal(g[k], w[k])
