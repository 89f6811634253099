"""The kernel gates at the port's four model-level dispatch points.

Each CUDA kernel takes fewer shapes and dtypes than the JAX function it
stands for, and each call site asks a pure predicate beside the kernel's
wrapper before it launches: ``decode_kernel_takes`` (``kv_attend``),
``flash_kernel_takes`` (``flash="auto"`` and the early error for
``flash=True``), ``int8_kernel_takes`` (``_Int8Weight._int8_product``)
and ``fused_block_takes`` (``DenseBlock.forward``).  A gate refuses only
where a kernel would launch, on a CUDA device, so the predicates are
called here with ``device_type="cuda"`` (no card needed): on the
configurations that used to reach a kernel that raises, and on the shapes
the kernels take.  Then each call site runs on the CPU with the
predicate's answer forced to "refused" and a kernel callable that raises:
the refused shape never reaches the kernel, and the path it takes matches
the JAX package's function on the same numpy-seeded inputs in f32
(attention and logits to 1e-5, DenseNet logits to 1e-4 as its other
tests).  Last, with nothing forced, the CPU paths that the other tests
use still go through the injected kernels (whose CPU versions are the
plain ones)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.config import ModelConfig as JaxModelConfig
from ddl_tpu.infer import decode as jd
from ddl_tpu.models import transformer as jt
from ddl_tpu.models.densenet import build_stages, forward_stages, init_stages
from ddl_tpu.ops import quant as jq
from ddl_tpu_torch.config import ModelConfig
from ddl_tpu_torch.infer import LMDecode, init_kv_cache, make_lm_generator
from ddl_tpu_torch.models import DenseNet, from_jax_params
from ddl_tpu_torch.models import densenet as tdn
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.models.convert import lm_params_from_jax
from ddl_tpu_torch.ops import flash_attention as tfa
from ddl_tpu_torch.ops import quant as tq
from ddl_tpu_torch.ops.decode_attention import decode_kernel_takes
from ddl_tpu_torch.ops.flash_attention import (
    FLASH_AUTO_MIN_T,
    flash_kernel_takes,
    require_flash_kernel,
    use_flash,
)
from ddl_tpu_torch.ops.fused_dense_block import fused_block_takes
from ddl_tpu_torch.ops.int8_matvec import int8_kernel_takes
from ddl_tpu_torch.parallel import sharding
from ddl_tpu_torch.parallel.sharding import LMMeshSpec, normalize_flash, resolve_auto_flash
from ddl_tpu_torch.train.lm_steps import make_lm_step_fns
from ddl_tpu_torch.train.state import Optimizer

BF16, F32, F16, I8 = torch.bfloat16, torch.float32, torch.float16, torch.int8
SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
             compute_dtype="float32")


def _raises(*args, **kwargs):
    raise AssertionError("a refused shape reached the kernel")


def _refuse(monkeypatch, module, name):
    monkeypatch.setattr(module, name, lambda *args, **kwargs: False)


# ---- the predicates on CUDA -------------------------------------------------

# (head_dim, query heads per K/V head, q dtype, cache dtype) -> taken
DECODE_CASES = {
    "head_dim 32 (LMConfig())": ((32, 1, BF16, BF16), False),
    "MQA, 12 query heads per K/V head": ((64, 12, BF16, I8), False),
    "f32 query and cache": ((64, 4, F32, F32), False),
    "head_dim 64 MHA, bf16 cache": ((64, 1, BF16, BF16), True),
    "head_dim 64 GQA 3, int8 cache": ((64, 3, BF16, I8), True),
    "head_dim 128 GQA 8, int8 cache": ((128, 8, BF16, I8), True),
}


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_takes_on_cuda(case):
    args, taken = DECODE_CASES[case]
    assert decode_kernel_takes(*args, "cuda") is taken
    assert decode_kernel_takes(*args, "cpu") is True


# (head_dim, dtype) -> taken
FLASH_CASES = {
    "head_dim 32 (LMConfig())": ((32, BF16), False),
    "head_dim 64 in f32": ((64, F32), False),
    "head_dim 64": ((64, BF16), True),
    "head_dim 128": ((128, BF16), True),
}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_takes_on_cuda(case):
    (head_dim, dtype), taken = FLASH_CASES[case]
    assert flash_kernel_takes(head_dim, dtype, "cuda") is taken
    assert flash_kernel_takes(head_dim, dtype, "cpu") is True
    assert flash_kernel_takes(head_dim, dtype, None) is True


def test_flash_auto_resolves_dense_where_the_kernel_cannot_run_on_cuda():
    default = tt.LMConfig(flash="auto")  # head_dim 32
    assert default.head_dim == 32
    assert not use_flash(default, FLASH_AUTO_MIN_T, "cuda")
    assert not resolve_auto_flash(default, LMMeshSpec(), FLASH_AUTO_MIN_T, "cuda")
    assert normalize_flash(default, LMMeshSpec(), FLASH_AUTO_MIN_T, "cuda").flash is False
    wide = tt.LMConfig(flash="auto", head_dim=64)
    assert use_flash(wide, FLASH_AUTO_MIN_T, "cuda")
    assert normalize_flash(wide, LMMeshSpec(), FLASH_AUTO_MIN_T, "cuda").flash is True
    assert not use_flash(wide, FLASH_AUTO_MIN_T - 1, "cuda")


def test_flash_true_where_the_kernel_cannot_run_raises_when_built():
    with pytest.raises(ValueError, match=r"head_dim in \(64, 128\)"):
        require_flash_kernel(tt.LMConfig(flash=True), "cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        require_flash_kernel(tt.LMConfig(flash=True, head_dim=64, compute_dtype="float32"),
                             "cuda")
    require_flash_kernel(tt.LMConfig(flash=True, head_dim=64), "cuda")
    require_flash_kernel(tt.LMConfig(flash=True), "cpu")
    require_flash_kernel(tt.LMConfig(flash="auto"), "cuda")  # resolves, never raises
    require_flash_kernel(tt.LMConfig(flash=True, causal=False), "cuda")  # dense anyway


# (M, D, contract_last, x dtype) -> taken
INT8_CASES = {
    "wo at d_ff 8192, M 8, (D, O)": ((8, 8192, False, BF16), True),
    "wi at d_model 2048, M 8, (D, O)": ((8, 2048, False, BF16), True),
    "head (O, D) at D 8192, M 8: too large": ((8, 8192, True, F32), False),
    "head (O, D) at D 768, M 8": ((8, 768, True, F32), True),
    "head (O, D) at D 8192, M 1": ((1, 8192, True, F32), True),
    "f16 x": ((4, 768, False, F16), False),
    "9 rows": ((9, 768, False, BF16), False),
}


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_kernel_takes_on_cuda(case):
    args, taken = INT8_CASES[case]
    assert int8_kernel_takes(*args, "cuda") is taken
    # off CUDA every product of at most 8 rows takes the wrapper
    assert int8_kernel_takes(*args, "cpu") is (args[0] <= 8)


# (dtype, growth, bn_size, C0) -> taken
FUSED_CASES = {
    "f32 maps": ((F32, 32, 4, 64), False),
    "growth 8": ((BF16, 8, 2, 16), False),
    "bottleneck 64": ((BF16, 32, 2, 64), False),
    "C0 not a multiple of 32": ((BF16, 32, 4, 48), False),
    "DenseNet121 block 1": ((BF16, 32, 4, 64), True),
    "DenseNet121 block 4": ((BF16, 32, 4, 512), True),
}


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_block_takes_on_cuda(case):
    args, taken = FUSED_CASES[case]
    assert fused_block_takes(*args, "cuda") is taken
    assert fused_block_takes(*args, "cpu") is True


# ---- each call site with its gate refusing ----------------------------------

def _caches(quant, rng, b=2, length=10, hkv=1, d=8):
    """A port cache and the same cache as the JAX package stores it."""
    k0 = torch.from_numpy(rng.standard_normal((b, length, hkv, d)).astype(np.float32))
    v0 = torch.from_numpy(rng.standard_normal((b, length, hkv, d)).astype(np.float32))
    if quant:
        (kq, ks), (vq, vs) = tq.quantize_q8(k0), tq.quantize_q8(v0)
        port = tq.QuantKV(tq.kv_fuse(kq), ks[..., 0].transpose(1, 2).contiguous(),
                          tq.kv_fuse(vq), vs[..., 0].transpose(1, 2).contiguous())
        return port, jq.QuantKV(*(jnp.asarray(a.numpy()) for a in port))
    port = (tq.kv_fuse(k0), tq.kv_fuse(v0))
    return port, tuple(jnp.asarray(a.numpy()) for a in port)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-layout", "int8"])
def test_kv_attend_refused_takes_the_dense_cores(monkeypatch, quant):
    """MQA, 12 query heads on one K/V head: the dense cores, as the JAX
    package's ``kv_attend`` without its kernel."""
    _refuse(monkeypatch, tq, "decode_kernel_takes")
    rng = np.random.default_rng(11)
    port, jax_cache = _caches(quant, rng)
    q = rng.standard_normal((2, 1, 12, 8)).astype(np.float32)
    mask = rng.random((1, 10)) > 0.3
    mask[..., 0] = True
    got = tq.kv_attend(torch.from_numpy(q), port, torch.from_numpy(mask), use_kernel=True,
                       decode=_raises)
    want = jq.kv_attend(jnp.asarray(q), jax_cache, jnp.asarray(mask), use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _lm(seed, **kw):
    jcfg = jt.LMConfig(**{**SMALL, **kw}, remat=False)
    tree = jt.TransformerLM(jcfg, None).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree["params"]))
    return jcfg, tt.LMConfig(**{**SMALL, **kw}), tree


def test_mqa_decode_steps_refused_match_jax(monkeypatch):
    """LMDecode with 12 query heads on one K/V head: every single-token
    step takes the dense core, never the decode callable."""
    _refuse(monkeypatch, tq, "decode_kernel_takes")
    jcfg, cfg, tree = _lm(12, n_heads=12, n_kv_heads=1)
    dec = LMDecode(cfg, decode_attend=_raises)
    dec.load_state_dict(lm_params_from_jax(tree))
    jdec = jd.LMDecode(jcfg)
    toks = np.random.default_rng(13).integers(0, 64, (2, 7))
    caches = init_kv_cache(cfg, 2, 7, device="cpu")
    jcaches = jd.init_kv_cache(jcfg, 2, 7)
    for off, t in ((0, 4), (4, 1), (5, 1), (6, 1)):
        with torch.no_grad():
            got, caches = dec(torch.from_numpy(toks[:, off:off + t]), caches, off)
        want, jcaches = jdec.apply({"params": tree}, jnp.asarray(toks[:, off:off + t]),
                                   jcaches, off)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_flash_auto_refused_prefill_is_dense_and_matches_jax(monkeypatch):
    """``flash="auto"`` over a FLASH_AUTO_MIN_T-token prompt with the flash
    gate refusing: the generator builds its model without the flash core,
    and its greedy tokens equal the JAX generator's dense ones."""
    _refuse(monkeypatch, tfa, "flash_kernel_takes")
    monkeypatch.setattr("ddl_tpu_torch.infer.decode.flash_attention", _raises)
    jcfg, cfg, tree = _lm(14, n_kv_heads=2, flash="auto")
    p, n, b = FLASH_AUTO_MIN_T, 4, 2
    prompt = np.random.default_rng(15).integers(0, 64, (b, p)).astype(np.int32)
    gen = make_lm_generator(cfg, prompt_len=p, max_new=n, batch=b, device="cpu")
    assert gen.model.blocks()[0].attn.attn_core is None
    got = gen(lm_params_from_jax(tree), torch.from_numpy(prompt))
    jgen = jd.make_lm_generator(jt.LMConfig(**{**SMALL, "n_kv_heads": 2}, remat=False),
                                prompt_len=p, max_new=n, batch=b, devices=jax.devices()[:1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgen(tree, jnp.asarray(prompt))))


def test_flash_true_refused_raises_before_any_work(monkeypatch):
    _refuse(monkeypatch, tfa, "flash_kernel_takes")
    _refuse(monkeypatch, sharding, "flash_kernel_takes")
    cfg = tt.LMConfig(**SMALL, flash=True)
    with pytest.raises(ValueError, match="flash=True"):
        make_lm_generator(cfg, prompt_len=4, max_new=2, device="cpu")
    with pytest.raises(ValueError, match="flash=True"):
        make_lm_step_fns(cfg, LMMeshSpec(), lambda p: Optimizer(p, 1e-3), 0, 2, 8,
                         device="cpu")
    # "auto" at the same length resolves to dense instead
    auto = tt.LMConfig(**SMALL, flash="auto")
    fns = make_lm_step_fns(auto, LMMeshSpec(), lambda p: Optimizer(p, 1e-3), 0, 2,
                           FLASH_AUTO_MIN_T, device="cpu")
    assert fns.init_state().model.blocks()[0].attn.attn_core is None


def test_int8_products_refused_take_the_large_product_and_match_jax(monkeypatch):
    """A 2 x 4 forward (8 rows, which the int8 matmul would take) with the
    int8 gate refusing: every product is the large-M one, as JAX's."""
    _refuse(monkeypatch, tt, "int8_kernel_takes")
    jcfg, cfg, tree = _lm(16)
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_lm_params(tree))
    model = tt.TransformerLM(cfg, int8_matmul=_raises)
    model.load_state_dict(tq.quantize_lm_params(lm_params_from_jax(tree)))
    toks = np.random.default_rng(17).integers(0, 64, (2, 4))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))[0].numpy()
    want = np.asarray(jt.TransformerLM(jcfg, None).apply({"params": qtree}, jnp.asarray(toks))[0])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


DENSENET = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16, bn_size=2,
                num_classes=5, dense_block_fused_blocks=(0, 3))


def _densenet_logits(fused_fn):
    """(port logits with fused blocks and ``fused_fn``, JAX packed-block
    logits) in f32 on the same seeded images, weights and running stats."""
    jcfg = JaxModelConfig(**DENSENET, dense_block_impl="packed", compute_dtype="float32",
                          remat=False)
    stages = build_stages(jcfg, num_stages=1)
    params, stats = jax.device_get(init_stages(stages, jax.random.key(0), 32))
    rng = np.random.default_rng(18)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), stats)
    x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    want, _ = forward_stages(stages, params, stats, jnp.asarray(x), train=False)
    model = DenseNet(ModelConfig(**DENSENET, dense_block_impl="fused",
                                 compute_dtype="float32"), num_stages=1, fused_fn=fused_fn)
    model.load_state_dict(from_jax_params(params, stats))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    return got.numpy(), np.asarray(want)


def test_fused_block_refused_runs_the_packed_block_and_matches_jax(monkeypatch):
    _refuse(monkeypatch, tdn, "fused_block_takes")
    got, want = _densenet_logits(_raises)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ---- the CPU paths the other tests use are unchanged ------------------------

def test_cpu_paths_still_reach_the_injected_kernels():
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    rng = np.random.default_rng(19)
    # decode: MQA at head_dim 8 through the decode callable
    port, _ = _caches(False, rng)
    q = torch.from_numpy(rng.standard_normal((2, 1, 12, 8)).astype(np.float32))
    tq.kv_attend(q, port, torch.ones(1, 10, dtype=torch.bool), use_kernel=True,
                 decode=spy("decode", tq.kv_decode))
    # flash: "auto" at head_dim 32 from FLASH_AUTO_MIN_T on, as before
    assert use_flash(tt.LMConfig(flash="auto"), FLASH_AUTO_MIN_T)
    assert use_flash(tt.LMConfig(flash="auto"), FLASH_AUTO_MIN_T, "cpu")
    gen = make_lm_generator(tt.LMConfig(**SMALL, flash="auto"), prompt_len=FLASH_AUTO_MIN_T,
                            max_new=1, device="cpu")
    assert gen.model.blocks()[0].attn.attn_core is not None
    # int8: 8 rows through the injected product, at any D
    _, cfg, tree = _lm(20)
    model = tt.TransformerLM(cfg, int8_matmul=spy("int8", tt.int8_matmul_small_m))
    model.load_state_dict(tq.quantize_lm_params(lm_params_from_jax(tree)))
    with torch.no_grad():
        model(torch.zeros(2, 4, dtype=torch.long))
    # fused block: growth 8 in f32 through fused_fn
    from ddl_tpu_torch.ops.fused_dense_block import fused_dense_block_plain
    _densenet_logits(spy("fused", fused_dense_block_plain))
    assert calls.count("decode") == 1
    assert calls.count("int8") == 2 * 6 + 1
    assert calls.count("fused") == 2
