"""The port's mixture-of-experts (``MoeMlp`` and its routing in
ddl_tpu_torch/models/transformer.py, the router metrics and capacity
anneal of the LM trainer, MoE decode and the bench flags) against the
JAX package on the same seeded inputs, in f32: the routing plan, both
dispatches bit for bit on the same gates (with tokens dropped), the
module's output, aux loss, router statistics and gradients (both
dispatches, grouped and whole-sequence routing, int8 expert banks), the
gather-only VJPs, four train steps, the capacity anneal, and greedy
generation."""

import dataclasses
import functools
import json
import warnings

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl_tpu.infer import decode as jd
from ddl_tpu.models import transformer as jt
from ddl_tpu.ops import quant as jq
from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns
from ddl_tpu_torch.bench import lm as bench_lm
from ddl_tpu_torch.infer import make_lm_generator
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.models.convert import lm_params_from_jax
from ddl_tpu_torch.ops.quant import quantize_lm_params
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import make_lm_step_fns
from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer
from ddl_tpu_torch.train.state import Optimizer

D, F, E = 32, 64, 4
MOE = dict(vocab_size=64, d_model=D, n_layers=2, n_heads=4, head_dim=8, d_ff=F,
           compute_dtype="float32", num_experts=E, expert_top_k=2)
# f32 on both sides, the same routing (f32 router, equal gates up to
# ~1e-7) and the expert products in another summation order: outputs,
# aux loss and gradients to 1e-5 of their largest value
TOL = 1e-5


def gates_of(seed, b, s, e=E, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, s, e)).astype(np.float32)
    if ties:  # equal gates: both frameworks must pick the lowest expert
        logits[:, ::3, 1] = logits[:, ::3, 2]
        logits[:, ::5, 0] = logits[:, ::5, 3]
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("group", [0, 1, 4, 6, 256])
@pytest.mark.parametrize("dispatch", ["auto", "sort", "einsum"])
def test_routing_plan_matches_jax(group, dispatch):
    for seq_len in (1, 7, 12, 16, 24, 4096):
        kw = dict(num_experts=E, moe_group=group, moe_dispatch=dispatch)
        assert tt.moe_routing_plan(tt.LMConfig(**kw), seq_len) == jt.moe_routing_plan(
            jt.LMConfig(**kw), seq_len), seq_len
    with pytest.raises(ValueError, match="moe_dispatch"):
        tt.moe_routing_plan(tt.LMConfig(num_experts=E, moe_dispatch="x"), 8)


@pytest.mark.parametrize("capacity", [1, 3, 12])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_top_k_dispatch_is_bit_equal_to_jax(capacity, ties):
    g = gates_of(0, 3, 8, ties=ties)
    dispatch, combine = tt._top_k_dispatch(torch.from_numpy(g), 2, capacity)
    jdispatch, jcombine = jt._top_k_dispatch(jnp.asarray(g), 2, capacity)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jdispatch))
    np.testing.assert_array_equal(combine.numpy(), np.asarray(jcombine))
    if capacity == 1:
        assert dispatch.sum() < 3 * 8 * 2  # tokens were dropped


@pytest.mark.parametrize("capacity", [1, 3, 12])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_sort_dispatch_is_bit_equal_to_jax(capacity, ties):
    g = gates_of(1, 3, 8, ties=ties)
    got = tt._sort_dispatch(torch.from_numpy(g), 2, capacity)
    want = jt._sort_dispatch(jnp.asarray(g), 2, capacity)
    names = ("slot_token", "slot_valid", "slot_choice", "choice_slot", "choice_keep",
             "choice_weight", "frac", "kept")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # both paths route alike: the einsum path's kept fraction per expert
    dispatch, _ = tt._top_k_dispatch(torch.from_numpy(g), 2, capacity)
    np.testing.assert_array_equal(dispatch.sum(-1).mean((0, 1)).numpy(), got[6].numpy())


def test_gather_vjps_equal_the_scatter_add_gradients():
    """The hand-written backward of each gather equals autograd's own
    gradient of the same gather (a scatter-add), in float64."""
    g = torch.from_numpy(gates_of(2, 2, 8)).double()
    st, sv, sc, cs, ck, _, _, _ = tt._sort_dispatch(g, 2, 3)
    x = torch.randn(2, 8, 5, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: tt._DispatchGather.apply(x, st, sv, cs, ck), (x,))
    ye = torch.randn(2, E * 3, 5, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda ye: tt._CombineGather.apply(ye, cs, sc, sv) * ck[..., None], (ye,))


def jax_moe(cfg_kw, x, seed=0, int8=False):
    """(JAX params as numpy, the apply function) of a JAX ``MoeMlp``."""
    mod = jt.MoeMlp(jt.LMConfig(**cfg_kw))
    params = nn.meta.unbox(mod.init(jax.random.key(seed), jnp.asarray(x))["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    if int8:
        q = jq.quantize_lm_params({"moe": params})["moe"]
        params = jax.tree_util.tree_map(np.asarray, q)
    return params, lambda p, x: mod.apply({"params": p}, x, mutable=["intermediates"])


def port_moe(cfg_kw, params):
    mod = tt.MoeMlp(tt.LMConfig(**cfg_kw))
    mod.load_state_dict(lm_params_from_jax(params))
    return mod


def close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-30), what


MODULE_CASES = {
    "einsum-groups": dict(moe_dispatch="einsum", moe_group=8),
    "einsum-whole": dict(moe_dispatch="einsum", moe_group=0),
    "sort-groups": dict(moe_dispatch="sort", moe_group=8),
    "sort-whole": dict(moe_dispatch="sort", moe_group=0),
    "einsum-drops": dict(moe_dispatch="einsum", moe_group=8, capacity_factor=0.5),
    "sort-drops": dict(moe_dispatch="sort", moe_group=8, capacity_factor=0.5),
}


@pytest.mark.parametrize("case", MODULE_CASES)
def test_moe_mlp_matches_jax(case):
    kw = {**MOE, **MODULE_CASES[case]}
    x = np.random.default_rng(3).standard_normal((2, 16, D)).astype(np.float32)
    params, apply = jax_moe(kw, x)

    def jloss(p, x):
        (y, aux), _ = apply(p, x)
        return (y * y).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    _, col = apply(params, jnp.asarray(x))
    mod = port_moe(kw, params)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = mod(xt)
    ((y * y).sum() + aux).backward()
    close(y.detach(), jy, "y")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL)
    drop, load = mod.router_stats
    inter = col["intermediates"]
    np.testing.assert_allclose(drop.item(), float(inter["moe_drop_frac"][0]), atol=1e-7)
    np.testing.assert_allclose(load.numpy(), np.asarray(inter["moe_expert_load"][0]), atol=1e-7)
    if "drops" in case:
        assert drop.item() > 0
    close(xt.grad, jgx, "dx")
    grads = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jgp))
    for name, p in mod.named_parameters():
        close(p.grad, grads[name], name)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_mlp_int8_banks_match_jax(dispatch):
    """quantize_lm_params' int8 wi/wo with (E, 1, out) scales: the module
    loads them as buffers and scales the einsum outputs as JAX does; the
    router stays f32 and trainable."""
    kw = {**MOE, "moe_dispatch": dispatch, "moe_group": 8}
    x = np.random.default_rng(4).standard_normal((2, 16, D)).astype(np.float32)
    params, apply = jax_moe(kw, x, int8=True)
    (jy, jaux), _ = apply(params, jnp.asarray(x))
    mod = port_moe(kw, params)
    assert mod.quantized and mod.wi.dtype == torch.int8 and mod.wi_scale.shape == (E, 1, F)
    assert [n for n, _ in mod.named_parameters()] == ["router.kernel"]
    y, aux = mod(torch.from_numpy(x))
    close(y.detach(), jy, "y")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL)
    # back to f32 banks: parameters again
    mod.load_state_dict(lm_params_from_jax(jax_moe(kw, x)[0]))
    assert not mod.quantized and isinstance(mod.wi, torch.nn.Parameter)


def test_moe_ep_alltoall_warns_as_jax_and_takes_the_one_device_dispatch():
    kw = {**MOE, "moe_group": 8}
    x = np.random.default_rng(5).standard_normal((2, 16, D)).astype(np.float32)
    params, _ = jax_moe(kw, x)
    a2a = {**kw, "moe_ep": "alltoall"}
    apply = jax_moe(a2a, x)[1]
    msgs, outs = [], []
    for run in (lambda: apply(params, jnp.asarray(x))[0],
                lambda: port_moe(a2a, params)(torch.from_numpy(x))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs.append(run()[0])
        msgs.append([str(w.message) for w in caught if "alltoall" in str(w.message)])
    jy, y = outs
    assert len(msgs[1]) == 1 and msgs[0] == msgs[1]
    close(y.detach(), jy, "y")
    y0, _ = port_moe(kw, params)(torch.from_numpy(x))
    torch.testing.assert_close(y, y0, rtol=0, atol=0)


def test_config_and_init():
    assert tt.LMConfig(num_experts=4).num_experts == 4
    for mod in (jt, tt):
        with pytest.raises(ValueError, match="capacity_factor_min"):
            mod.LMConfig(num_experts=4, capacity_factor_min=0)
    cfg = tt.LMConfig(vocab_size=256, d_model=256, n_layers=1, n_heads=4, head_dim=64,
                      d_ff=1024, num_experts=4)
    model = tt.TransformerLM(cfg)
    tt.init_lm_weights(model, 0)
    moe = model.block0.moe
    assert not hasattr(model.block0, "mlp")
    # lecun_normal per expert: fan-in d_model for wi, d_ff for wo, and for
    # the router its d_model rows
    for w, fan_in in ((moe.wi, 256), (moe.wo, 1024), (moe.router.kernel, 256)):
        target = (1.0 / fan_in) ** 0.5
        assert abs(w.std().item() / target - 1) < 0.05
        assert w.abs().max().item() <= 2 * target / 0.87962566103423978 + 1e-6
    for e in range(4):
        assert abs(moe.wi[e].std().item() / (1 / 16) - 1) < 0.03
    jtree = jt.TransformerLM(jt.LMConfig(**dataclasses.asdict(cfg))).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    want = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jtree["params"])))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    assert "block0.moe.wi" in tt.dense_kernel_names(model)
    assert "block0.moe.router.kernel" not in tt.dense_kernel_names(model)


def test_lm_with_moe_matches_jax_and_remat_routes_once():
    """The whole LM: logits and the summed aux loss as JAX's; under full
    remat the gradients equal those without it, and the router statistics
    are those of the forward (the recompute rewrites the same values)."""
    kw = {**MOE, "moe_group": 8}
    jcfg = jt.LMConfig(**kw, remat=False)
    tree = jt.TransformerLM(jcfg).init(jax.random.key(1), jnp.zeros((1, 16), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree["params"]))
    toks = np.random.default_rng(6).integers(0, 64, (2, 16))
    jlogits, jaux = jt.TransformerLM(jcfg).apply({"params": tree}, jnp.asarray(toks))
    grads, stats = [], []
    for remat in (False, True):
        model = tt.TransformerLM(tt.LMConfig(**kw, remat=remat))
        model.load_state_dict(lm_params_from_jax(tree))
        logits, aux = model(torch.from_numpy(toks))
        close(logits.detach(), jlogits, "logits")
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL)
        stats.append([m.router_stats for m in model.modules() if isinstance(m, tt.MoeMlp)])
        (logits.square().mean() + aux).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-7, msg=k)
    for (d0, l0), (d1, l1) in zip(*stats):
        assert d0.item() == d1.item() and torch.equal(l0, l1)


# ---------------------------------------------------------------- steps

BATCH, SEQ, STEPS, LR = 4, 16, 4, 1e-3
STEP_CFG = {**MOE, "moe_group": 8, "capacity_factor": 1.0}
# f32 on both sides: losses to 1e-5 relative, every parameter after four
# AdamW steps to 1e-5 absolute, the drop fraction exactly (the same
# routing decisions, counted)
STEP_RTOL, PARAM_ATOL = 1e-5, 1e-5
STEP_CASES = {
    "einsum": {},
    "sort": dict(moe_dispatch="sort"),
    "ce_chunk": dict(ce_chunk=4),
    "ce_vocab_chunk": dict(ce_vocab_chunk=16),
}


def _batches():
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 64, (STEPS, BATCH, SEQ + 1))
    return [(t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)) for t in toks]


@functools.cache
def _jax_run(case: str, accum_steps: int = 1):
    cfg = jt.LMConfig(**STEP_CFG, **STEP_CASES[case])
    fns = jax_make_lm_step_fns(cfg, JaxMeshSpec(), optax.adamw(LR), jax.random.key(0),
                               BATCH, SEQ, accum_steps=accum_steps)
    state = fns.init_state()
    params0 = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    metrics = []
    for inp, tgt in _batches():
        state, m = fns.train(state, jnp.asarray(inp), jnp.asarray(tgt))
        metrics.append({k: float(v) for k, v in m.items()})
    return params0, metrics, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


def _port_fns(case, accum_steps=1, **extra):
    cfg = tt.LMConfig(**{**STEP_CFG, **STEP_CASES[case], **extra})
    return make_lm_step_fns(cfg, LMMeshSpec(), lambda p: Optimizer(p, LR, weight_decay=1e-4),
                            seed=0, batch=BATCH, seq_len=SEQ, device="cpu",
                            accum_steps=accum_steps)


def _four_port_steps(case, accum_steps=1):
    """The port's four steps from JAX's initial weights, held to JAX's
    trajectory (losses, aux, router metrics, the parameters after them)."""
    params0, want, want_params = _jax_run(case, accum_steps)
    fns = _port_fns(case, accum_steps)
    state = fns.init_state()
    state.model.load_state_dict(lm_params_from_jax(params0))
    got = []
    for inp, tgt in _batches():
        state, m = fns.train(state, torch.from_numpy(inp).long(), torch.from_numpy(tgt).long())
        got.append({k: v.item() for k, v in m.items()})
    assert sorted(got[0]) == sorted(want[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(g["moe_aux"], w["moe_aux"], rtol=STEP_RTOL)
        for k in ("moe_drop_frac", "moe_load_max", "moe_load_min"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, err_msg=k)
    assert max(g["moe_drop_frac"] for g in got) > 0  # capacity 1.0 drops tokens
    params = state.model.state_dict()
    for k, v in lm_params_from_jax(want_params).items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("case", STEP_CASES)
def test_four_moe_steps_match_jax(case):
    _four_port_steps(case)


@pytest.mark.parametrize("case", ["einsum", "sort"])
def test_moe_accumulation_matches_jax(case):
    """accum_steps=2: each half of the batch routed on its own, the chunks'
    mean gradient and mean metrics, as the JAX factory's scan does."""
    _four_port_steps(case, accum_steps=2)


def test_moe_eval_and_accumulation():
    """Eval carries the router metrics.  Two accumulation chunks route
    each half on its own: the routing groups lie within a sequence, so the
    forward's ce and drop fraction equal the full batch's, and so does the
    gradient of every weight the aux loss does not reach (the head, the
    final norm, the last block's expert banks); the aux loss, a product of
    two batch means, is not the mean of its chunks'."""
    full, accum = _port_fns("einsum"), _port_fns("einsum", accum_steps=2)
    s_full, s_acc = full.init_state(), accum.init_state()
    inp, tgt = (torch.from_numpy(a).long() for a in _batches()[0])
    ev = full.evaluate(s_full, inp, tgt)
    assert {"accuracy", "moe_drop_frac", "moe_load_max", "moe_load_min"} <= set(ev)
    _, m_full = full.train(s_full, inp, tgt)
    _, m_acc = accum.train(s_acc, inp, tgt)
    np.testing.assert_allclose(m_acc["ce"].item(), m_full["ce"].item(), rtol=1e-6)
    np.testing.assert_allclose(m_acc["moe_drop_frac"].item(), m_full["moe_drop_frac"].item(),
                               atol=1e-7)
    assert m_full["moe_drop_frac"].item() > 0
    assert abs(m_acc["moe_aux"].item() - m_full["moe_aux"].item()) > 1e-6
    g_full = {k: p.grad for k, p in s_full.model.named_parameters()}
    g_acc = {k: p.grad for k, p in s_acc.model.named_parameters()}
    last = f"block{STEP_CFG['n_layers'] - 1}.moe"
    for k in ("lm_head.kernel", "norm_f.scale", f"{last}.wi", f"{last}.wo"):
        close(g_acc[k], g_full[k], k)
    # the router's gradient carries the aux term, so it moves
    router = f"{last}.router.kernel"
    assert (g_acc[router] - g_full[router]).abs().max() > TOL * g_full[router].abs().max()


def test_capacity_anneal(capsys):
    """After tests/test_loop.py::test_moe_capacity_anneal: the trainer drops
    capacity_factor to capacity_factor_min once the live moe_drop_frac is
    under capacity_anneal_drop, in the running model too; the state
    carries over.  Disabled when the target equals the running capacity;
    by step with capacity_anneal_step."""
    base = dict(vocab_size=256, d_model=32, n_layers=1, n_heads=4, head_dim=8, d_ff=64,
                num_experts=4, expert_top_k=2, moe_group=0, compute_dtype="float32",
                remat=False, capacity_factor=1.5, capacity_factor_min=1.0)
    run = LMRunConfig(batch=4, seq_len=16, steps=6, log_every=2, log_dir=None)

    def trainer(**kw):
        return LMTrainer(tt.LMConfig(**{**base, **kw}), LMMeshSpec(),
                         lambda p: Optimizer(p, 1e-3), run, device="cpu")

    t = trainer(capacity_anneal_drop=1.0)
    model, opt = t.state.model, t.state.optimizer
    t.train()
    out = capsys.readouterr().out
    assert t.cfg.capacity_factor == 1.0 and t.state.step == 6
    assert t.state.model is model and t.state.optimizer is opt
    assert model.block0.moe.capacity_factor == 1.0
    assert out.count("capacity anneal: router drop_frac") == 1
    assert "capacity_factor 1.5 -> 1.0" in out

    t = trainer(capacity_factor_min=1.5, capacity_anneal_drop=1.0)
    t.train()
    assert t.cfg.capacity_factor == 1.5 and "capacity anneal" not in capsys.readouterr().out

    t = trainer(capacity_anneal_drop=0.0, capacity_anneal_step=4)
    t.train()
    out = capsys.readouterr().out
    assert t.cfg.capacity_factor == 1.0 and "step 4 >= capacity_anneal_step 4" in out


# --------------------------------------------------------------- decode

def _decode_setup(seed=3, **kw):
    kw = {**MOE, **kw}
    jcfg = jt.LMConfig(**kw, remat=False)
    tree = jt.TransformerLM(jcfg).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree["params"]))
    return jcfg, tt.LMConfig(**kw), tree


@pytest.mark.parametrize("int8", [False, True], ids=["f32-banks", "int8-banks"])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_greedy_generation_matches_jax(dispatch, int8):
    """The prefill routes the prompt in groups, each step its one token
    alone, as the JAX generator does; with quantize_lm_params' weights the
    expert banks decode int8 too."""
    jcfg, cfg, tree = _decode_setup(moe_dispatch=dispatch, moe_group=4)
    if int8:
        tree = jax.tree_util.tree_map(np.asarray, jq.quantize_lm_params(tree))
    p, n, b = 8, 6, 2
    prompt = np.random.default_rng(4).integers(0, 64, (b, p)).astype(np.int32)
    jgen = jd.make_lm_generator(jcfg, prompt_len=p, max_new=n, batch=b,
                                devices=jax.devices()[:1])
    want = np.asarray(jgen(tree, jnp.asarray(prompt)))
    gen = make_lm_generator(cfg, prompt_len=p, max_new=n, batch=b, device="cpu")
    got = gen(lm_params_from_jax(tree), torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), want)
    if int8:
        assert gen.model.block0.moe.quantized
        params = quantize_lm_params(lm_params_from_jax(_decode_setup(
            moe_dispatch=dispatch, moe_group=4)[2]))
        torch.testing.assert_close(gen(params, torch.from_numpy(prompt)), got, rtol=0, atol=0)


def test_moe_sampled_generation_is_self_consistent():
    """tests/test_decode.py::test_sampled_generation_and_moe on the port:
    a fixed generator gives the same tokens, other seeds diverge."""
    _, cfg, tree = _decode_setup(seed=0, vocab_size=32)
    params = lm_params_from_jax(tree)
    b, p, n = 2, 4, 4
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 32, (b, p)))
    gen = make_lm_generator(cfg, prompt_len=p, max_new=n, batch=b, temperature=0.8,
                            device="cpu")
    a = gen(params, prompt, torch.Generator().manual_seed(7))
    torch.testing.assert_close(gen(params, prompt, torch.Generator().manual_seed(7)), a,
                               rtol=0, atol=0)
    assert a.shape == (b, n) and bool(((a >= 0) & (a < 32)).all())
    others = [gen(params, prompt, torch.Generator().manual_seed(s)) for s in (8, 9, 10)]
    assert any(not torch.equal(a, o) for o in others)


def test_bench_lm_with_experts_on_the_cpu(capsys):
    bench_lm.main(["--batch", "2", "--seq-len", "16", "--d-model", "64", "--layers", "2",
                   "--vocab", "256", "--iters", "1", "--device", "cpu", "--experts", "4",
                   "--d-ff", "64", "--moe-group", "6", "--ce-chunk", "8"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["experts"] == "4top2" and row["d_ff"] == 64 and row["capacity_factor"] == 1.5
    # the resolved plan: no divisor of 16 at or under 6 reaches half of it
    # but 4, so groups of 4 and the einsum
    assert (row["moe_dispatch"], row["moe_group"]) == jt.moe_routing_plan(
        jt.LMConfig(num_experts=4, moe_group=6), 16)
    assert row["ce_chunk"] == 8 and row["ce_vocab_chunk"] == 0 and row["device"] == "cpu"
    assert 0 <= row["moe_drop_frac"] < 1 and row["moe_load_min"] <= 0.25 <= row["moe_load_max"]
    assert np.isfinite(row["loss"]) and "hbm_peak_bytes" not in row
