"""The port's chunked head+CE losses (ddl_tpu_torch/ops/losses.py) and the
``ce_chunk`` / ``ce_vocab_chunk`` train steps against the JAX package on
the same seeded inputs, in f32: the token-chunked and the vocab-streamed
loss, their gradients and accuracy (a chunk that does not divide T or V
gives JAX's warning and divisor; the one-hot form; the accuracy's
tie-break between blocks), that neither keeps a (B, T, V) tensor for the
backward, and four AdamW steps of the LM with each loss edge against
JAX's trajectory."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
from ddl_tpu.ops import losses as jl
from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns
from ddl_tpu_torch.models.convert import lm_params_from_jax
from ddl_tpu_torch.models.transformer import LMConfig
from ddl_tpu_torch.ops import losses as tl
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import make_lm_step_fns
from ddl_tpu_torch.train.state import Optimizer

B, T, D, V = 2, 16, 32, 96
# f32 on both sides, the same sums in another order (per chunk or per
# block, then over chunks): the loss to 1e-6 relative and the gradients to
# 1e-6 of their largest value (measured ~1e-7 on the CPU).
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-6


def inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, T, D)).astype(dtype)
    w = (rng.standard_normal((V, D)) / np.sqrt(D)).astype(np.float32)
    targets = rng.integers(0, V, (B, T)).astype(np.int32)
    return hidden, w, targets


def port_value_and_grads(fn, hidden, w, targets):
    h = torch.from_numpy(hidden).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ce, acc = fn(h, wt, torch.from_numpy(targets).long())
    ce.backward()
    return ce.item(), None if acc is None else acc.item(), h.grad.numpy(), wt.grad.numpy()


def jax_value_and_grads(fn, hidden, w, targets):
    (ce, acc), (dh, dw) = jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(w), jnp.asarray(targets))
    return float(ce), None if acc is None else float(acc), np.asarray(dh), np.asarray(dw)


def assert_same(got, want):
    ce, acc, dh, dw = got
    jce, jacc, jdh, jdw = want
    np.testing.assert_allclose(ce, jce, rtol=LOSS_RTOL)
    assert acc == jacc
    for g, w in ((dh, jdh), (dw, jdw)):
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("chunk", [4, 5, 16, 64])
@pytest.mark.parametrize("use_onehot", [False, True], ids=["gather", "onehot"])
def test_token_chunked_ce_matches_jax(chunk, use_onehot):
    hidden, w, targets = inputs()
    got = port_value_and_grads(lambda h, wt, t: tl.fused_chunked_ce(
        h, wt, t, chunk, with_accuracy=True, use_onehot=use_onehot), hidden, w, targets)
    want = jax_value_and_grads(lambda h, wt, t: jl.fused_chunked_ce(
        h, wt, t, chunk, with_accuracy=True, use_onehot=use_onehot), hidden, w, targets)
    assert_same(got, want)
    dense = tl.cross_entropy_loss(torch.from_numpy(hidden) @ torch.from_numpy(w).t(),
                                  torch.from_numpy(targets))
    np.testing.assert_allclose(got[0], dense.item(), rtol=LOSS_RTOL)


@pytest.mark.parametrize("chunk", [32, 40, 96, 500])
def test_vocab_chunked_ce_matches_jax(chunk):
    hidden, w, targets = inputs(1)
    got = port_value_and_grads(lambda h, wt, t: tl.fused_vocab_chunked_ce(
        h, wt, t, chunk, True), hidden, w, targets)
    want = jax_value_and_grads(lambda h, wt, t: jl.fused_vocab_chunked_ce(
        h, wt, t, chunk, True), hidden, w, targets)
    assert_same(got, want)


def test_bf16_hidden_gives_bf16_dx_and_f32_dw():
    """The JAX dtypes: dx in hidden's dtype, dW in w's; the loss from the
    same bf16 values as JAX's (f32 products of the widened hidden)."""
    hidden, w, targets = inputs(2)
    hb = torch.from_numpy(hidden).bfloat16()
    for name, fn, jfn in (
            ("token", lambda h, wt, t: tl.fused_chunked_ce(h, wt, t, 4),
             lambda h, wt, t: jl.fused_chunked_ce(h, wt, t, 4)),
            ("vocab", lambda h, wt, t: tl.fused_vocab_chunked_ce(h, wt, t, 32),
             lambda h, wt, t: jl.fused_vocab_chunked_ce(h, wt, t, 32))):
        h = hb.clone().requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        ce, _ = fn(h, wt, torch.from_numpy(targets).long())
        ce.backward()
        assert h.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32, name
        jh = jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)
        want = float(jfn(jh, jnp.asarray(w), jnp.asarray(targets))[0])
        np.testing.assert_allclose(ce.item(), want, rtol=LOSS_RTOL, err_msg=name)


def _warning(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught if "does not divide" in str(w.message)]


@pytest.mark.parametrize("which, chunk", [("token", 5), ("vocab", 40)])
def test_non_dividing_chunk_warns_as_jax_does(which, chunk):
    hidden, w, targets = inputs(3)
    args = (hidden, w, targets, chunk)
    if which == "token":
        got = _warning(lambda: tl.fused_chunked_ce(*map(torch.from_numpy, args[:3]), chunk))
        want = _warning(lambda: jl.fused_chunked_ce(*map(jnp.asarray, args[:3]), chunk))
        assert tl.effective_chunk(chunk, T) == jl.effective_chunk(chunk, T) == 4
    else:
        got = _warning(lambda: tl.fused_vocab_chunked_ce(*map(torch.from_numpy, args[:3]), chunk))
        want = _warning(lambda: jl.fused_vocab_chunked_ce(*map(jnp.asarray, args[:3]), chunk))
        assert tl._vocab_blocks(V, chunk) == jl._vocab_blocks(V, chunk) == 32
    assert got and got[0] == want[0]


def test_effective_chunk_and_bad_chunks_match_jax():
    for t in range(1, 40):
        for c in (1, 3, 7, 8, 64):
            assert tl.effective_chunk(c, t) == jl.effective_chunk(c, t)
    hidden, w, targets = map(torch.from_numpy, inputs())
    with pytest.raises(ValueError, match="token_chunk"):
        tl.fused_chunked_ce(hidden, w, targets, 0)
    with pytest.raises(ValueError, match="vocab_chunk"):
        tl.fused_vocab_chunked_ce(hidden, w, targets, 0)


def test_accuracy_tie_break_first_block_then_first_index():
    """Two vocab rows with equal logits: the dense argmax, JAX's
    vocab-streamed accuracy and the port's pick the same (first) index,
    whether the tie lies within a block or across blocks."""
    hidden, w, targets = inputs(4)
    w[40] = w[7]  # across the 32-row blocks
    w[20] = w[7]  # within block 0
    h = hidden.copy()
    h[:, :, :] = w[7] * 5.0  # every position's largest logit is the tie
    targets[:] = 7
    targets[0, :3] = 40
    for chunk in (32, 96):
        _, acc = tl.fused_vocab_chunked_ce(torch.from_numpy(h), torch.from_numpy(w),
                                           torch.from_numpy(targets).long(), chunk, True)
        _, jacc = jl.fused_vocab_chunked_ce(jnp.asarray(h), jnp.asarray(w),
                                            jnp.asarray(targets), chunk, True)
        assert acc.item() == float(jacc) == (B * T - 3) / (B * T)
    _, acc = tl.fused_chunked_ce(torch.from_numpy(h), torch.from_numpy(w),
                                 torch.from_numpy(targets).long(), 4, with_accuracy=True)
    assert acc.item() == (B * T - 3) / (B * T)


def test_onehot_cross_entropy_mean_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, (B, T))
    ce, out = tl.onehot_cross_entropy_mean(torch.from_numpy(logits).bfloat16(),
                                           torch.from_numpy(labels))
    jce, jout = jl.onehot_cross_entropy_mean(jnp.asarray(logits).astype(jnp.bfloat16),
                                             jnp.asarray(labels))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(ce.item(), float(jce), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def _largest_saved(fn, *args):
    """The largest tensor (in elements) autograd keeps for the backward of
    ``fn(*args)[0]``."""
    sizes = [0]

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return max(sizes)


def test_chunked_losses_keep_no_full_logits_for_the_backward():
    """The dense loss keeps its (B, T, V) logits for the backward; the two
    chunked losses keep nothing larger than their inputs (hidden, the head
    kernel), at a T where the logits outgrow both."""
    b, t, d, v = 2, 64, 16, 96
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).requires_grad_()
    wt = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).requires_grad_()
    tg = torch.from_numpy(rng.integers(0, v, (b, t)))
    dense = _largest_saved(lambda: tl.cross_entropy_loss(h @ wt.t(), tg))
    token = _largest_saved(lambda: tl.fused_chunked_ce(h, wt, tg, 4))
    vocab = _largest_saved(lambda: tl.fused_vocab_chunked_ce(h, wt, tg, 32))
    assert dense == b * t * v
    assert token <= max(b * t * d, v * d) < dense
    assert vocab <= max(b * t * d, v * d)


# ---------------------------------------------------------------- steps

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
            compute_dtype="float32")
BATCH, SEQ, STEPS, LR = 4, 16, 4, 1e-3
# f32 on both sides: the losses to 1e-5 relative, every parameter after
# four AdamW steps to 1e-5 absolute (as tests/test_torch_lm_train.py's
# dense-CE steps)
STEP_RTOL, PARAM_ATOL = 1e-5, 1e-5
EDGES = {"ce_chunk": dict(ce_chunk=4), "ce_vocab_chunk": dict(ce_vocab_chunk=16)}


def _batches():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, TINY["vocab_size"], (STEPS, BATCH, SEQ + 1))
    return [(t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)) for t in toks]


@functools.cache
def _jax_run(edge: str):
    cfg = JaxLMConfig(**TINY, **EDGES[edge])
    fns = jax_make_lm_step_fns(cfg, JaxMeshSpec(), optax.adamw(LR), jax.random.key(0),
                               BATCH, SEQ)
    state = fns.init_state()
    params0 = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    losses = []
    for inp, tgt in _batches():
        state, m = fns.train(state, jnp.asarray(inp), jnp.asarray(tgt))
        losses.append(float(m["loss"]))
    ev = fns.evaluate(state, *map(jnp.asarray, _batches()[0]))
    return (params0, losses, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params)),
            {k: float(v) for k, v in ev.items()})


@pytest.mark.parametrize("edge", EDGES)
def test_four_steps_with_a_chunked_loss_match_jax(edge):
    params0, want_losses, want_params, want_eval = _jax_run(edge)
    cfg = LMConfig(**TINY, **EDGES[edge])
    fns = make_lm_step_fns(cfg, LMMeshSpec(), lambda p: Optimizer(p, LR, weight_decay=1e-4),
                           seed=0, batch=BATCH, seq_len=SEQ, device="cpu")
    state = fns.init_state()
    state.model.load_state_dict(lm_params_from_jax(params0))
    losses = []
    for inp, tgt in _batches():
        state, m = fns.train(state, torch.from_numpy(inp).long(), torch.from_numpy(tgt).long())
        losses.append(m["loss"].item())
        assert "accuracy" not in m
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_RTOL)
    got = state.model.state_dict()
    for k, v in lm_params_from_jax(want_params).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)
    ev = fns.evaluate(state, *(torch.from_numpy(a).long() for a in _batches()[0]))
    for k in ("loss", "ce", "accuracy"):
        np.testing.assert_allclose(ev[k].item(), want_eval[k], rtol=STEP_RTOL, err_msg=k)
