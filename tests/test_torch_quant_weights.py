"""Weight-only int8 in the port (ops/quant.py's ``quantize_lm_params`` and
``head_kernel``, the int8 branches of ``QDense``/``LMHead``, the converter and
the generator) against the JAX package on the same trees.

``quantize_lm_params`` is bit-equal (the same f32 absmax, divide and
round-half-even); the quantized forward and decode steps match JAX's in f32
to 1e-5 (the same exact int8 values and f32 products, summed in another
order); the ``kv+w`` generator's greedy tokens are equal.  On the CPU every
product of at most 8 rows goes through the int8 matmul wrapper's plain
version, and no launch is counted."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.infer import decode as jd
from ddl_tpu.models import transformer as jt
from ddl_tpu.ops import quant as jq
from ddl_tpu_torch.infer import LMDecode, init_kv_cache, make_lm_generator
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.models.convert import lm_params_from_jax, lm_params_to_jax
from ddl_tpu_torch.ops.int8_matvec import int8_matmul_small_m
from ddl_tpu_torch.ops.quant import head_kernel, quantize_lm_params

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
             compute_dtype="float32")


def jax_tree(seed=0, **kw):
    jcfg = jt.LMConfig(**{**SMALL, **kw}, remat=False)
    tree = jt.TransformerLM(jcfg, None).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    return jcfg, jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree["params"]))


def quantized(seed=0, **kw):
    """(JAX config, port config, JAX int8 tree, port int8 state_dict)."""
    jcfg, tree = jax_tree(seed, **kw)
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_lm_params(tree))
    return jcfg, tt.LMConfig(**{**SMALL, **kw}), qtree, quantize_lm_params(
        lm_params_from_jax(tree))


def flat(tree):
    return {k: v.numpy() for k, v in lm_params_from_jax(tree).items()}


def test_quantize_lm_params_is_bit_equal_to_jax_with_experts_and_router():
    """The MoE tree carries expert banks (int8 + (E, 1, out) scales) and a
    router, which stays f32; every other kernel is int8 beside its scale."""
    _, tree = jax_tree(num_experts=4, expert_top_k=2, moe_group=0)
    want = flat(jax.tree_util.tree_map(np.asarray, jq.quantize_lm_params(tree)))
    got = {k: v.numpy() for k, v in quantize_lm_params(lm_params_from_jax(tree)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["block0.moe.wi"].dtype == np.int8 and got["block0.moe.wi_scale"].shape == (4, 1, 64)
    assert got["block0.moe.router.kernel"].dtype == np.float32
    assert "block0.moe.router.scale" not in got
    assert got["lm_head.scale"].shape == (64, 1) and got["block0.attn.q.scale"].shape == (1, 32)
    assert got["embed.embedding"].dtype == got["norm_f.scale"].dtype == np.float32


def test_quantize_lm_params_raises_on_nothing_to_quantize():
    with pytest.raises(ValueError, match="no matmul kernel"):
        quantize_lm_params({"norm.scale": torch.ones(4)})


def test_head_kernel_dequantizes_and_passes_f32_through():
    _, tree = jax_tree()
    sd = lm_params_from_jax(tree)
    q = quantize_lm_params(sd)
    got = head_kernel(q)
    want = jq.head_kernel(jax.tree_util.tree_map(jnp.asarray, jq.quantize_lm_params(tree))[
        "lm_head"])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got - sd["lm_head.kernel"]).abs().max() <= q["lm_head.scale"].max() / 2 + 1e-7
    assert head_kernel(sd) is sd["lm_head.kernel"]


def test_lm_params_from_jax_keeps_int8_leaves():
    _, _, qtree, _ = quantized()
    sd = lm_params_from_jax(qtree)
    assert sd["block0.attn.q.kernel"].dtype == torch.int8
    assert sd["lm_head.kernel"].dtype == torch.int8
    assert sd["block0.attn.q.scale"].dtype == sd["embed.embedding"].dtype == torch.float32
    back = lm_params_to_jax(sd)
    for path, leaf in jax.tree_util.tree_leaves_with_path(qtree):
        node = back
        for k in path:
            node = node[k.key]
        assert node.dtype == leaf.dtype
        np.testing.assert_array_equal(node, leaf)


def test_quantized_forward_and_decode_steps_match_jax():
    """A 2 x 8 forward (16 rows: the large-M product) and single-token
    decode steps (2 rows: the int8 matmul wrapper), f32, 1e-5."""
    jcfg, cfg, qtree, qsd = quantized(seed=1)
    toks = np.random.default_rng(2).integers(0, 64, (2, 8))
    model = tt.TransformerLM(cfg)
    model.load_state_dict(qsd)
    assert model.block0.attn.q.kernel.dtype == torch.int8 and model.lm_head.quantized
    with torch.no_grad():
        got = model(torch.from_numpy(toks))[0].numpy()
    want = np.asarray(jt.TransformerLM(jcfg, None).apply({"params": qtree}, jnp.asarray(toks))[0])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    dec = LMDecode(cfg)
    dec.load_state_dict(qsd)
    jdec = jd.LMDecode(jcfg)
    caches = init_kv_cache(cfg, 2, 8, device="cpu")
    jcaches = jd.init_kv_cache(jcfg, 2, 8)
    counts = int8_matmul_small_m.launches
    for off, t in ((0, 5), (5, 1), (6, 1), (7, 1)):
        with torch.no_grad():
            got, caches = dec(torch.from_numpy(toks[:, off:off + t]), caches, off)
        want, jcaches = jdec.apply({"params": qtree}, jnp.asarray(toks[:, off:off + t]),
                                   jcaches, off)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert int8_matmul_small_m.launches == counts


def test_int8_products_route_by_row_count():
    """At most 8 rows go through the injected product, more rows do not."""
    _, cfg, _, qsd = quantized()
    calls = []

    def spy(x, w8, scale, contract_last=False):
        calls.append((x.shape[0], contract_last))
        return int8_matmul_small_m(x, w8, scale, contract_last=contract_last)

    model = tt.TransformerLM(cfg, int8_matmul=spy)
    model.load_state_dict(qsd)
    with torch.no_grad():
        model(torch.zeros(2, 4, dtype=torch.long))
    assert len(calls) == 2 * 6 + 1 and set(calls) == {(8, False), (8, True)}
    calls.clear()
    with torch.no_grad():
        model(torch.zeros(3, 3, dtype=torch.long))
    assert calls == []


def test_kv_and_weight_int8_generator_matches_jax():
    """int8 weights, the int8 cache, GQA and a window smaller than the
    cache (the rolling ring), greedy, f32: tokens equal."""
    kw = dict(n_kv_heads=2, attn_window=6)
    jcfg, cfg, qtree, qsd = quantized(seed=3, **kw)
    p, n, b = 9, 8, 2
    prompt = np.random.default_rng(4).integers(0, 64, (b, p)).astype(np.int32)
    jgen = jd.make_lm_generator(jcfg, prompt_len=p, max_new=n, batch=b, kv_quant=True,
                                devices=jax.devices()[:1])
    want = np.asarray(jgen(qtree, jnp.asarray(prompt)))
    gen = make_lm_generator(cfg, prompt_len=p, max_new=n, batch=b, kv_quant=True, device="cpu")
    got = gen(qsd, torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), want)
    assert gen.model.block0.attn.k.kernel.dtype == torch.int8


def test_bf16_generator_serves_int8_weights_as_they_are():
    """The generator casts only floating dense kernels to bf16: the int8
    kernels load as int8 with their scales, and the greedy tokens are ones
    the f32 model on the same int8 weights ranks first or within noise."""
    _, cfg, _, qsd = quantized(seed=5, compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, 64, (2, 8)))
    gen = make_lm_generator(cfg, prompt_len=8, max_new=5, batch=2, device="cpu")
    toks = gen(qsd, prompt)
    assert gen.model.block1.mlp.wo.kernel.dtype == torch.int8
    f32 = tt.TransformerLM(dataclasses.replace(cfg, compute_dtype="float32"))
    f32.load_state_dict(qsd)
    seq = torch.cat([prompt, toks], 1)
    with torch.no_grad():
        logits = f32(seq)[0][:, 7:-1]
    picked = logits.gather(-1, toks[..., None])[..., 0]
    assert (logits.max(-1).values - picked).max() <= 2e-2 * logits.abs().max()


def test_strict_load_demands_every_scale_and_converts_back():
    _, cfg, _, qsd = quantized()
    with torch.device("meta"):
        model = tt.TransformerLM(cfg)
    missing = {k: v for k, v in qsd.items() if k != "block1.mlp.wi.scale"}
    with pytest.raises(RuntimeError, match="block1.mlp.wi.scale"):
        model.load_state_dict(missing, assign=True)
    model.load_state_dict(qsd, assign=True)
    assert not isinstance(model.lm_head.kernel, torch.nn.Parameter)
    assert model.lm_head.kernel.dtype == torch.int8
    # an f32 state_dict turns the modules back into f32 parameters
    f32 = {k: v for k, v in lm_params_from_jax(jax_tree()[1]).items()}
    model.load_state_dict(f32, assign=True)
    assert isinstance(model.block0.attn.q.kernel, torch.nn.Parameter)
    assert "block0.attn.q.scale" not in model.state_dict()
