"""The port's LM train step (ddl_tpu_torch/train/lm_steps.py) against the
JAX package's ``make_lm_step_fns`` on the same weights (carried across by
``models/convert.lm_params_from_jax``) and the same seeded batches: three
AdamW steps in f32 with dropout 0, dense and flash attention (the JAX
flash kernels in interpret mode, the port's plain forward and backward),
losses and every parameter after the steps; then the port's own
invariants: gradient accumulation equals the full batch, the remat
policies give equal gradients, dropout under remat recomputes the same
masks, and eval is deterministic."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns
from ddl_tpu_torch.models.convert import lm_params_from_jax
from ddl_tpu_torch.models.transformer import REMAT_POLICIES, LMConfig
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import (
    dropout_kwargs,
    dropout_step_key,
    make_lm_step_fns,
)
from ddl_tpu_torch.train.state import Optimizer

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
            compute_dtype="float32")
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
# f32 on both sides, the same math in another summation order: the losses
# to 1e-5 (relative) and every parameter after three AdamW steps to 1e-5
# (absolute; the weights are O(0.1-1) and each step moves them by ~lr;
# measured 2.1e-7 and 2.4e-7 on the CPU).
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _adamw(params):
    """optax.adamw(LR): decoupled weight decay 1e-4 (optax's default)."""
    return Optimizer(params, LR, weight_decay=1e-4)


def _batches(n=STEPS, batch=BATCH, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, TINY["vocab_size"], (n, batch, SEQ + 1))
    return [(t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)) for t in toks]


@functools.cache
def _jax_run(flash: bool):
    """(initial params as numpy, per-step losses, final params) of JAX's
    three steps."""
    cfg = JaxLMConfig(**TINY, flash=flash)
    fns = jax_make_lm_step_fns(cfg, JaxMeshSpec(), optax.adamw(LR), jax.random.key(0),
                               BATCH, SEQ)
    state = fns.init_state()
    params0 = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    losses = []
    for inp, tgt in _batches():
        state, m = fns.train(state, jnp.asarray(inp), jnp.asarray(tgt))
        losses.append(float(m["loss"]))
    return params0, losses, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


def _port_fns(batch=BATCH, accum_steps=1, **cfg_kw):
    cfg = LMConfig(**{**TINY, **cfg_kw})
    return make_lm_step_fns(cfg, LMMeshSpec(), _adamw, seed=0, batch=batch, seq_len=SEQ,
                            device="cpu", accum_steps=accum_steps)


def _state_from(fns, params0):
    state = fns.init_state()
    state.model.load_state_dict(lm_params_from_jax(params0))
    return state


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_three_steps_match_jax(flash):
    params0, want_losses, want_params = _jax_run(flash)
    fns = _port_fns(flash=flash)
    state = _state_from(fns, params0)
    losses = []
    for inp, tgt in _batches():
        state, m = fns.train(state, torch.from_numpy(inp), torch.from_numpy(tgt))
        losses.append(m["loss"].item())
    assert state.step == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    want = lm_params_from_jax(want_params)
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=k)


def _grads(fns, state, inp, tgt):
    """One train step's gradients (the update is applied too)."""
    fns.train(state, torch.from_numpy(inp), torch.from_numpy(tgt))
    return {k: p.grad.clone() for k, p in state.model.named_parameters()}


def test_accum_steps_equals_the_full_batch():
    params0 = _jax_run(False)[0]
    (inp, tgt), = _batches(1, batch=8)
    full = _port_fns(batch=8)
    accum = _port_fns(batch=8, accum_steps=2)
    s_full, s_acc = _state_from(full, params0), _state_from(accum, params0)
    _, m_full = full.train(s_full, torch.from_numpy(inp), torch.from_numpy(tgt))
    _, m_acc = accum.train(s_acc, torch.from_numpy(inp), torch.from_numpy(tgt))
    torch.testing.assert_close(m_acc["loss"], m_full["loss"], rtol=1e-6, atol=0)
    for (k, a), b in zip(s_acc.model.named_parameters(), s_full.model.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-7, msg=k)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=k)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_remat_policies_give_equal_gradients(policy, flash):
    params0 = _jax_run(False)[0]
    (inp, tgt), = _batches(1)
    off = _port_fns(flash=flash, remat=False)
    on = _port_fns(flash=flash, remat=True, remat_policy=policy)
    want = _grads(off, _state_from(off, params0), inp, tgt)
    got = _grads(on, _state_from(on, params0), inp, tgt)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-7, msg=k)


def test_unknown_remat_policy_raises():
    fns = _port_fns(remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        fns.init_state().model(torch.zeros(1, 4, dtype=torch.long))


def test_dropout_under_remat_recomputes_the_same_masks():
    """With dropout on, remat recomputes each block in the backward pass;
    the block re-seeds its generator there, so the gradients equal remat
    off for the same seed and step -- and differ from another step's."""
    params0 = _jax_run(False)[0]
    (inp, tgt), = _batches(1)
    off = _port_fns(remat=False, dropout_rate=0.3)
    on = _port_fns(remat=True, remat_policy="full", dropout_rate=0.3)
    want = _grads(off, _state_from(off, params0), inp, tgt)
    got = _grads(on, _state_from(on, params0), inp, tgt)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-7, msg=k)
    later = _state_from(on, params0)
    later.step = 1
    other = _grads(on, later, inp, tgt)
    assert not torch.allclose(other["block0.mlp.wi.kernel"], want["block0.mlp.wi.kernel"])
    nodrop = _port_fns(remat=False)
    plain = _grads(nodrop, _state_from(nodrop, params0), inp, tgt)
    assert not torch.allclose(plain["block0.mlp.wi.kernel"], want["block0.mlp.wi.kernel"])


def test_dropout_kwargs_and_keys():
    assert dropout_kwargs(0, None, 0.5) == {"deterministic": True, "rngs": None}
    assert dropout_kwargs(0, 3, 0.0) == {"deterministic": True, "rngs": None}
    kw = dropout_kwargs(0, 3, 0.5)
    assert kw["deterministic"] is False and kw["rngs"] == {"dropout": dropout_step_key(0, 3)}
    keys = {dropout_step_key(s, t) for s in range(3) for t in range(50)}
    assert len(keys) == 150 and all(0 <= k < 2 ** 63 for k in keys)


def test_eval_is_deterministic_and_matches_jax_loss():
    params0 = _jax_run(False)[0]
    (inp, tgt), = _batches(1, seed=9)
    fns = _port_fns(dropout_rate=0.3)
    state = _state_from(fns, params0)
    a = fns.evaluate(state, torch.from_numpy(inp), torch.from_numpy(tgt))
    b = fns.evaluate(state, torch.from_numpy(inp), torch.from_numpy(tgt))
    assert set(a) == {"loss", "ce", "moe_aux", "accuracy"}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["moe_aux"].item() == 0.0
    cfg = JaxLMConfig(**TINY, dropout_rate=0.3)
    jfns = jax_make_lm_step_fns(cfg, JaxMeshSpec(), optax.adamw(LR), jax.random.key(0),
                                BATCH, SEQ)
    jstate = jfns.init_state()
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params0))
    want = jfns.evaluate(jstate, jnp.asarray(inp), jnp.asarray(tgt))
    for k in ("loss", "ce", "accuracy"):
        np.testing.assert_allclose(a[k].item(), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("kwargs, exc, match", [
    (dict(accum_steps=0), ValueError, "accum_steps"),
    (dict(accum_steps=3), ValueError, "accum_steps"),
    (dict(pipeline_schedule="nope"), ValueError, "schedule"),
    (dict(pipeline_schedule="1f1b"), NotImplementedError, "item 11"),
    (dict(virtual_stages=2), NotImplementedError, "item 11"),
    (dict(num_microbatches=2), NotImplementedError, "item 11"),
    (dict(zero_sharding=True), NotImplementedError, "item 9"),
    (dict(cfg=dict(ce_chunk=4)), None, "builds and steps"),
    (dict(cfg=dict(ce_vocab_chunk=16)), None, "builds and steps"),
    (dict(cfg=dict(attn_impl="ring")), NotImplementedError, "item 11"),
    (dict(cfg=dict(attn_impl="sparse")), ValueError, "attn_impl"),
    (dict(cfg=dict(causal=False, flash=True)), ValueError, "causal"),
    (dict(cfg=dict(flash="off")), ValueError, "flash"),
])
def test_factory_argument_checks(kwargs, exc, match):
    """Each refused argument raises; the chunked loss edges (``exc`` None),
    refused until they were ported, build and take a step."""
    kwargs = dict(kwargs)
    cfg = LMConfig(**{**TINY, **kwargs.pop("cfg", {})})
    if exc is None:
        fns = make_lm_step_fns(cfg, LMMeshSpec(), _adamw, 0, BATCH, SEQ, device="cpu", **kwargs)
        inp, tgt = (torch.from_numpy(a).long() for a in _batches()[0])
        state, m = fns.train(fns.init_state(), inp, tgt)
        assert state.step == 1 and np.isfinite(m["loss"].item())
        return
    with pytest.raises(exc, match=match):
        make_lm_step_fns(cfg, LMMeshSpec(), _adamw, 0, BATCH, SEQ, device="cpu", **kwargs)


def test_mesh_axes_above_one_raise_and_device_none_means_cuda():
    with pytest.raises(NotImplementedError, match="item 11"):
        LMMeshSpec(data=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        LMMeshSpec(pipe=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_lm_step_fns(LMConfig(**TINY), LMMeshSpec(), _adamw, 0, BATCH, SEQ)


def test_flash_auto_resolves_on_the_port_threshold():
    from ddl_tpu_torch.ops.flash_attention import FLASH_AUTO_MIN_T
    from ddl_tpu_torch.parallel.sharding import normalize_flash

    auto = LMConfig(**TINY, flash="auto")
    assert normalize_flash(auto, LMMeshSpec(), FLASH_AUTO_MIN_T).flash is True
    assert normalize_flash(auto, LMMeshSpec(), FLASH_AUTO_MIN_T - 1).flash is False
    assert normalize_flash(dataclasses.replace(auto, causal=False), LMMeshSpec(),
                           10 ** 6).flash is False
