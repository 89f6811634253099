"""The port's KV-cached generation (ddl_tpu_torch/infer/decode.py) against
the JAX package's ``LMDecode`` and ``make_lm_generator`` on the same
weights, in f32: prefill and incremental logits (1e-5), greedy tokens
equal for MHA, GQA, the flash prefill, a sliding window with the rolling
cache and the int8 cache; sampling; the argument checks and the device
rule.  Every kernel wrapper takes its plain version on the CPU."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.infer import decode as jd
from ddl_tpu.models import transformer as jt
from ddl_tpu_torch.infer import LMDecode, init_kv_cache, make_lm_generator
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.models.convert import lm_params_from_jax
from ddl_tpu_torch.ops.flash_attention import FLASH_AUTO_MIN_T, flash_attention
from ddl_tpu_torch.ops.quant import QuantKV

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
             compute_dtype="float32")


def setup(seed=0, **kw):
    kw = {**SMALL, **kw}
    jcfg = jt.LMConfig(**kw, remat=False)
    tree = jt.TransformerLM(jcfg, None).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree["params"]))
    return jcfg, tt.LMConfig(**kw), tree, lm_params_from_jax(tree)


def decoder(cfg, params, **kw):
    model = LMDecode(cfg, **kw)
    model.load_state_dict(params)
    return model.eval()


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2}], ids=["mha", "gqa"])
def test_prefill_and_incremental_match_jax_and_the_full_forward(kw):
    jcfg, cfg, tree, params = setup(**kw)
    toks = np.random.default_rng(1).integers(0, 64, (2, 7))
    full = tt.TransformerLM(cfg)
    full.load_state_dict(params)
    ref = full(torch.from_numpy(toks))[0].detach().numpy()
    dec = decoder(cfg, params)
    jdec = jd.LMDecode(jcfg)
    # prefill of the first 4 tokens, then one token at a time
    caches = init_kv_cache(cfg, 2, 7, device="cpu")
    jcaches = jd.init_kv_cache(jcfg, 2, 7)
    with torch.no_grad():
        got, caches = dec(torch.from_numpy(toks[:, :4]), caches, 0)
    want, jcaches = jdec.apply({"params": tree}, jnp.asarray(toks[:, :4]), jcaches, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref[:, :4], atol=1e-5, rtol=1e-5)
    for i in range(4, 7):
        with torch.no_grad():
            got, caches = dec(torch.from_numpy(toks[:, i:i + 1]), caches, i)
        want, jcaches = jdec.apply({"params": tree}, jnp.asarray(toks[:, i:i + 1]), jcaches, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[:, 0].numpy(), ref[:, i], atol=1e-5, rtol=1e-5)
    for (k, v), (jk, jv) in zip(caches, jcaches):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)


def test_last_only_and_last_index_slice_before_the_head():
    _, cfg, _, params = setup()
    dec = decoder(cfg, params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (1, 6)))
    with torch.no_grad():
        full = dec(toks, init_kv_cache(cfg, 1, 6, device="cpu"), 0)[0]
        last = dec(toks, init_kv_cache(cfg, 1, 6, device="cpu"), 0, last_only=True)[0]
        at3 = dec(toks, init_kv_cache(cfg, 1, 6, device="cpu"), 0, last_index=3)[0]
    assert last.shape == at3.shape == (1, 1, 64)
    torch.testing.assert_close(last[:, 0], full[:, -1])
    torch.testing.assert_close(at3[:, 0], full[:, 3])


GENERATORS = {
    "mha": (dict(), dict()),
    "gqa": (dict(n_kv_heads=2), dict()),
    "flash": (dict(n_kv_heads=2, flash=True), dict()),
    "window-rolling": (dict(attn_window=5), dict(rolling=True)),
    "kv-quant": (dict(n_kv_heads=2), dict(kv_quant=True)),
}


@pytest.mark.parametrize("case", GENERATORS)
def test_greedy_tokens_match_jax_generator(case):
    cfg_kw, gen_kw = GENERATORS[case]
    jcfg, cfg, tree, params = setup(seed=3, **cfg_kw)
    p, n, b = 9, 7, 2
    prompt = np.random.default_rng(4).integers(0, 64, (b, p)).astype(np.int32)
    jgen = jd.make_lm_generator(jcfg, prompt_len=p, max_new=n, batch=b,
                                devices=jax.devices()[:1], **gen_kw)
    want = np.asarray(jgen(tree, jnp.asarray(prompt)))
    gen = make_lm_generator(cfg, prompt_len=p, max_new=n, batch=b, device="cpu", **gen_kw)
    got = gen(params, torch.from_numpy(prompt))
    assert got.shape == (b, n) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_generation_tracks_the_f32_teacher():
    """bf16 compute through every plain kernel: the greedy tokens are a
    sequence the f32 model would also rank first or within its noise."""
    _, cfg, _, params = setup(seed=5, compute_dtype="bfloat16", flash=True)
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, 64, (2, 8)))
    toks = make_lm_generator(cfg, prompt_len=8, max_new=5, batch=2, device="cpu")(params, prompt)
    f32 = tt.TransformerLM(dataclasses.replace(cfg, compute_dtype="float32"))
    f32.load_state_dict(params)
    seq = torch.cat([prompt, toks], 1)
    logits = f32(seq)[0][:, 7:-1].detach()
    picked = logits.gather(-1, toks[..., None])[..., 0]
    assert (logits.max(-1).values - picked).max() <= 2e-2 * logits.abs().max()


def test_sampling_is_seeded_and_top_k_restricts_the_support():
    _, cfg, _, params = setup(seed=7)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, 64, (1, 6)).repeat(64, 0))
    kw = dict(prompt_len=6, max_new=1, batch=64, temperature=2.0, device="cpu")
    gen = make_lm_generator(cfg, **kw)
    a = gen(params, prompt, torch.Generator().manual_seed(1))
    b = gen(params, prompt, torch.Generator().manual_seed(1))
    c = gen(params, prompt, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    top3 = make_lm_generator(cfg, top_k=3, **kw)(params, prompt)
    with torch.no_grad():
        first = tt.TransformerLM(cfg)
        first.load_state_dict(params)
        allowed = set(first(prompt[:1])[0][0, -1].topk(3).indices.tolist())
    assert set(top3.flatten().tolist()) <= allowed and len(set(top3.flatten().tolist())) > 1
    greedy = make_lm_generator(cfg, prompt_len=6, max_new=4, batch=2, device="cpu")
    k1 = make_lm_generator(cfg, prompt_len=6, max_new=4, batch=2, temperature=1.3, top_k=1,
                           device="cpu")
    torch.testing.assert_close(greedy(params, prompt[:2]), k1(params, prompt[:2]), rtol=0, atol=0)


@pytest.mark.parametrize("kwargs, match", [
    (dict(max_len=5), "max_len"),
    (dict(top_k=2), "temperature"),
    (dict(temperature=1.0, top_k=0), "range"),
    (dict(temperature=1.0, top_k=65), "range"),
    (dict(rolling=True), "attn_window"),
])
def test_generator_argument_errors(kwargs, match):
    _, cfg, _, _ = setup()
    with pytest.raises(ValueError, match=match):
        make_lm_generator(cfg, prompt_len=4, max_new=4, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="causal"):
        make_lm_generator(dataclasses.replace(cfg, causal=False), prompt_len=4, max_new=4,
                          device="cpu")


def test_generator_device_defaults_to_cuda():
    """No device argument means CUDA; without a card that raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    _, cfg, _, _ = setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_lm_generator(cfg, prompt_len=4, max_new=4)


def test_flash_auto_resolves_against_the_port_threshold():
    _, cfg, _, _ = setup()
    auto = dataclasses.replace(cfg, flash="auto")
    short = make_lm_generator(auto, prompt_len=FLASH_AUTO_MIN_T - 1, max_new=1, device="cpu")
    long = make_lm_generator(auto, prompt_len=FLASH_AUTO_MIN_T, max_new=1, device="cpu")
    assert short.model.block0.attn.attn_core is None
    assert long.model.block0.attn.attn_core.func is flash_attention


def test_init_kv_cache_layouts():
    cfg = tt.LMConfig(**{**SMALL, "n_kv_heads": 2, "attn_window": 6})
    caches = init_kv_cache(cfg, 3, 20, device="cpu")
    assert len(caches) == 2 and caches[0][0].shape == (3, 20, 16)
    tensors = [t for c in caches for t in c]
    assert len({t.data_ptr() for t in tensors}) == len(tensors)  # written in place: no sharing
    ring = init_kv_cache(cfg, 3, 20, rolling=True, device="cpu")
    assert ring[0][0].shape == (3, 6, 16)
    q = init_kv_cache(cfg, 3, 20, quant=True, device="cpu")[0]
    assert isinstance(q, QuantKV) and q.kq.dtype == torch.int8 and q.ks.shape == (3, 2, 20)
    with pytest.raises(ValueError, match="quant"):
        init_kv_cache(cfg, 3, 20, dtype=torch.float32, quant=True)
    with pytest.raises(ValueError, match="attn_window"):
        init_kv_cache(tt.LMConfig(**SMALL), 3, 20, rolling=True)
