"""The serving engine's paged KV pool, scheduler and admission control
(ddl_tpu_torch/serve/kv_pool.py, scheduler.py, admission.py) against the
JAX package's.

Host half: one seeded sequence of operations through the JAX objects and
the port's, comparing every return value, every raised error (type and
message) and ``stats()`` after every step -- the allocator with its prefix
index (alloc, share, free, mark and drop indexed, eviction under pressure,
compaction plan and commit), the scheduler (admit, retire, park,
``fits_ever``, private demand, remap) and admission control under every
shed policy.

Device half: each pool function bit-equal to JAX's on bf16 and int8 pools,
idle lanes with out-of-range ids (dropped, a batch with no kept lane
included), clipped gathers (never NaN), a block copy and a permutation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
from ddl_tpu.ops.quant import QuantKV as JaxQuantKV
from ddl_tpu.serve import admission as jadm
from ddl_tpu.serve import kv_pool as jkv
from ddl_tpu.serve import scheduler as jsch
from ddl_tpu_torch.models.transformer import LMConfig
from ddl_tpu_torch.ops.quant import QuantKV
from ddl_tpu_torch.serve import admission as tadm
from ddl_tpu_torch.serve import kv_pool as tkv
from ddl_tpu_torch.serve import scheduler as tsch
from ddl_tpu_torch.serve.engine import pow2_at_least, pow2_at_most, prompt_bucket


def _call(fn, *args, **kw):
    """What a call did: ("ok", value) or ("raise", type name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 -- the error itself is compared
        return ("raise", type(e).__name__, str(e))


# --- host half ------------------------------------------------------------


def test_geometry_helpers_match_jax():
    from ddl_tpu.serve import engine as je

    for n in range(1, 70):
        assert tkv.blocks_for(n, 8) == jkv.blocks_for(n, 8)
        assert prompt_bucket(n, 8) == je.prompt_bucket(n, 8)
        assert pow2_at_most(n) == je.pow2_at_most(n)
        assert pow2_at_least(n) == je.pow2_at_least(n)
    for fn, jfn in ((tkv.blocks_for, jkv.blocks_for), (prompt_bucket, je.prompt_bucket)):
        assert _call(fn, 0, 8) == _call(jfn, 0, 8)
    assert _call(pow2_at_most, 0) == _call(je.pow2_at_most, 0)


def _allocator_trace(mod, seed: int) -> list:
    """A seeded sequence of allocator and prefix-index operations: random
    allocs, shares, frees and prompt registrations over a small pool (so
    that eviction and exhaustion happen), double frees and bad shares,
    drop_indexed, and a compaction after every tenth step."""
    rng = np.random.default_rng(seed)
    alloc = mod.BlockAllocator(12, 4)
    index = mod.PrefixIndex(4)
    alloc.on_evict = index.forget_block
    owned = []  # block lists held by "requests"
    prompts = [rng.integers(0, 9, int(rng.integers(4, 14))) for _ in range(6)]
    trace = []
    for step in range(160):
        op = rng.integers(0, 9)
        if op <= 2:
            n = int(rng.integers(0, 5))
            r = _call(alloc.alloc, n)
            if r[0] == "ok":
                owned.append(list(r[1]))
        elif op == 3 and owned:
            ids = owned[int(rng.integers(len(owned)))]
            r = _call(alloc.share, ids)
            if r[0] == "ok":
                owned.append(list(ids))
        elif op == 4 and owned:
            r = _call(alloc.free, owned.pop(int(rng.integers(len(owned)))))
        elif op == 5:
            # a request's prompt: share its cached chain, allocate the rest,
            # register it (prefix reuse and eviction under pressure)
            p = prompts[int(rng.integers(len(prompts)))]
            keys = index.chain_keys(p)
            chain = index.lookup(p, keys)
            need = tkv.blocks_for(len(p), 4) - len(chain)
            r = _call(alloc.share, chain)
            if r[0] == "ok" and need > 0:
                got = _call(alloc.alloc, need)
                if got[0] == "ok":
                    ids = chain + list(got[1])
                    r = ("ok", ids, index.insert(p, ids, alloc, keys=keys))
                    owned.append(ids)
                else:
                    alloc.free(chain)
                    r = got
            elif r[0] == "ok":
                owned.append(list(chain))
        elif op == 6:
            r = _call(alloc.free, [int(rng.integers(0, 14))])  # often a double free
        elif op == 7:
            r = _call(alloc.share, [int(rng.integers(0, 12))])  # maybe a free block
        else:
            bid = int(rng.integers(0, 12))
            r = (_call(alloc.mark_indexed, bid) if rng.integers(2)
                 else _call(alloc.drop_indexed, bid))
        if step % 10 == 9:
            plan = alloc.compaction_plan()
            if plan:
                index.remap(plan)
                owned = [[plan.get(i, i) for i in ids] for ids in owned]
                alloc.commit_plan(plan)
            r = (r, plan)
        trace.append((step, r, alloc.stats(), len(index), alloc.fragmentation(),
                      sorted(alloc._refs.items()), list(alloc._evictable), sorted(alloc._free)))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_prefix_index_match_jax(seed):
    got, want = _allocator_trace(tkv, seed), _allocator_trace(jkv, seed)
    assert got == want
    # the sequence reaches what it exists to reach
    assert any("'raise'" in repr(r[1]) for r in want)
    assert want[-1][2]["evictions"] > 0


def _request(mod, rid, rng, lo=3, hi=30, max_new=(1, 12), prompts=None):
    prompt = (prompts[int(rng.integers(len(prompts)))] if prompts is not None
              else rng.integers(0, 9, int(rng.integers(lo, hi))).astype(np.int32))
    return mod.Request(id=rid, prompt=prompt, max_new=int(rng.integers(*max_new)),
                       tenant="t" if rng.integers(2) else None,
                       priority_class="batch" if rng.integers(3) == 0 else None)


def _scheduler_trace(kv, sch, seed: int, min_free: int) -> list:
    """Admissions through a prefix-indexed scheduler (shared prompts, so
    full and partial prefix hits and copy-on-write reservations happen),
    retirements, a park of every lane, ``fits_ever`` and ``private_need``
    of each request, and a defrag remap."""
    rng = np.random.default_rng(seed)
    alloc = kv.BlockAllocator(24, 4)
    index = kv.PrefixIndex(4)
    alloc.on_evict = index.forget_block
    s = sch.ContinuousScheduler(alloc, max_batch=3, max_blocks_per_seq=10,
                                min_free_blocks=min_free, prefix_index=index)
    prompts = [rng.integers(0, 9, n).astype(np.int32) for n in (8, 12, 13, 4, 30, 41)]
    trace = []
    for step in range(120):
        op = rng.integers(0, 5)
        if op <= 1:
            req = _request(sch, f"r{step}", rng, prompts=prompts)
            shared = s.cached_prefix(req)
            r = (list(shared), s.private_need(req, len(shared)), s.fits_ever(req),
                 s.can_admit(req), s.blocks_needed(req))
            st = _call(s.try_admit, req)
            if st[0] == "ok" and st[1] is not None:
                lane = st[1]
                lane.prefill_done = True
                index.insert(req.prompt, lane.block_ids, alloc, keys=req.chain_keys)
                st = ("ok", (lane.lane, lane.block_ids, lane.cached_tokens,
                             lane.shared_blocks, lane.prefill_pos, lane.cow_block))
            elif st[0] == "ok":
                st = ("ok", None)
            r = (r, st)
        elif op == 2 and s.active():
            lane = s.active()[int(rng.integers(len(s.active())))].lane
            r = _call(s.retire, lane)
            r = (r[0], r[1].lane if r[0] == "ok" else r[1:])
        elif op == 3:
            r = _call(s.retire, int(rng.integers(0, 3)))  # maybe an idle lane
            r = (r[0], r[1].lane if r[0] == "ok" else r[1:])
        else:
            if rng.integers(4) == 0:
                r = ("park", [st.lane for st in s.park_all()])
            else:
                plan = alloc.compaction_plan()
                if plan:
                    s.remap_blocks(plan)
                    index.remap(plan)
                    alloc.commit_plan(plan)
                r = ("defrag", plan)
        trace.append((step, r, alloc.stats(), s.peak_lanes, s.free_lane(),
                      [(l.lane, l.block_ids, l.cow_block) for l in s.active()]))
    return trace


@pytest.mark.parametrize("seed,min_free", [(0, 0), (1, 2), (2, 5)])
def test_scheduler_matches_jax(seed, min_free):
    got = _scheduler_trace(tkv, tsch, seed, min_free)
    want = _scheduler_trace(jkv, jsch, seed, min_free)
    assert got == want
    admits = [r[1][1] for r in want if isinstance(r[1], tuple) and len(r[1]) == 2
              and isinstance(r[1][0], tuple)]
    assert any(a[0] == "ok" and a[1] is not None and a[1][-1] is not None for a in admits), \
        "a fully cached prompt reserved a copy-on-write block"


class _Recorder:
    """An obs stand-in recording every emitted event."""

    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append((kind, fields))


@pytest.mark.parametrize("policy", ["reject", "shed_oldest"])
@pytest.mark.parametrize("trace", [True, False])
def test_admission_matches_jax(policy, trace):
    def drive(adm, sch):
        rng = np.random.default_rng(4)
        obs, shed = _Recorder(), []
        ctl = adm.AdmissionController(max_queue=3, policy=policy, obs=obs,
                                      on_shed=lambda r, why: shed.append((r.id, why)),
                                      trace=trace)
        out = []
        for i in range(14):
            req = _request(sch, f"q{i}", rng)
            req.traced = bool(rng.integers(3))
            if rng.integers(4) == 0 and len(ctl):
                popped = ctl.pop()
                ctl.shed_request(popped, "too_large")
                out.append(("popped", popped.id))
            out.append((ctl.offer(req, fits_ever=bool(rng.integers(5))), len(ctl),
                        ctl.peek().id if ctl.peek() else None, ctl.admitted, ctl.shed))
        return out, obs.events, shed

    assert drive(tadm, tsch) == drive(jadm, jsch)
    assert tadm.POLICIES == jadm.POLICIES
    for bad in (dict(policy="nope"), dict(max_queue=0)):
        assert _call(tadm.AdmissionController, **bad) == _call(jadm.AdmissionController, **bad)


def test_request_and_tenant_tags_match_jax():
    for kw in (dict(max_new=0, prompt=[1]), dict(max_new=2, prompt=[])):
        assert _call(tsch.Request, id="x", **kw) == _call(jsch.Request, id="x", **kw)
    for tenant, pc in ((None, None), ("acme", None), ("", "batch"), ("a", "interactive")):
        t = tsch.Request(id="x", prompt=[1, 2], max_new=3, tenant=tenant, priority_class=pc)
        j = jsch.Request(id="x", prompt=[1, 2], max_new=3, tenant=tenant, priority_class=pc)
        assert tsch.tenant_tags(t) == jsch.tenant_tags(j)
        assert t.total_tokens() == j.total_tokens()


# --- device half ----------------------------------------------------------

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, n_kv_heads=2,
           d_ff=64, compute_dtype="bfloat16")
NB, BS = 8, 4


def _np(x):
    if torch.is_tensor(x):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _same(got, want):
    """Bit-equal layer by layer (bf16 compared through f32, exact)."""
    gl, wl = list(got), list(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_array_equal(_np(g), _np(w))


def _pools(quant):
    jcfg, cfg = JaxLMConfig(**CFG), LMConfig(**CFG)
    jp = jkv.init_kv_pool(jcfg, NB, BS, quant=quant)
    tp = tkv.init_kv_pool(cfg, NB, BS, quant=quant, device="cpu")
    for j, t in zip(jp, tp):
        _same(t, j)
    ptrs = [a.data_ptr() for layer in tp for a in layer]
    assert len(set(ptrs)) == len(ptrs)  # every tensor its own (written in place)
    return jcfg, cfg, list(jp), list(tp)


def _kv(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _prefill_cache(rng, quant, t, hkv=2, dh=8):
    """A (1, t, fused) contiguous cache in both frameworks' layouts."""
    k4, v4 = _kv(rng, 1, t, hkv, dh), _kv(rng, 1, t, hkv, dh)
    if quant:
        from ddl_tpu.ops.quant import quantize_q8

        def fuse(x):
            q, s = quantize_q8(jnp.asarray(x))
            return q.reshape(1, t, -1), s[..., 0].transpose(0, 2, 1)

        (kq, ks), (vq, vs) = fuse(k4), fuse(v4)
        jc = JaxQuantKV(kq, ks, vq, vs)
        tc = QuantKV(*(torch.from_numpy(np.array(a)) for a in jc))
        return jc, tc
    jc = (jnp.asarray(k4.reshape(1, t, -1), jnp.bfloat16),
          jnp.asarray(v4.reshape(1, t, -1), jnp.bfloat16))
    tc = tuple(torch.from_numpy(x.reshape(1, t, -1)).to(torch.bfloat16) for x in (k4, v4))
    return jc, tc


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_pool_functions_bit_equal_to_jax(quant):
    rng = np.random.default_rng(11)
    _, _, jp, tp = _pools(quant)
    # prefill scatters: ids past the pool (bucket padding) are dropped,
    # including a write with no kept id at all
    for ids in ([2, 5, NB, NB + 3], [7, 0], [NB, NB + 1], [NB + 2, 3, 1, NB]):
        jc, tc = _prefill_cache(rng, quant, len(ids) * BS)
        jp[0] = jkv.pool_write_prefill(jp[0], jc, jnp.asarray(ids, jnp.int32))
        out = tkv.pool_write_prefill(tp[0], tc, torch.tensor(ids))
        assert out is tp[0]  # written in place
        _same(tp[0], jp[0])
    # a host sequence of ids works as well
    jc, tc = _prefill_cache(rng, quant, 2 * BS)
    jp[1] = jkv.pool_write_prefill(jp[1], jc, jnp.asarray([4, 6], jnp.int32))
    tkv.pool_write_prefill(tp[1], tc, [4, 6])
    _same(tp[1], jp[1])
    # token writes: idle lanes (id NB) dropped, then a step with every lane idle
    for blk, slot in (([5, NB, 2, NB], [3, 0, 1, 2]), ([NB, NB, NB, NB], [0, 1, 2, 3]),
                      ([1, 4, 6, 0], [0, 3, 2, 1])):
        k, v = _kv(rng, 4, 1, 2, 8), _kv(rng, 4, 1, 2, 8)
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
        jp[0] = jkv.pool_write_token(jp[0], jk, jv, jnp.asarray(blk), jnp.asarray(slot))
        tkv.pool_write_token(tp[0], tk, tv, torch.tensor(blk), torch.tensor(slot))
        _same(tp[0], jp[0])
        # the same step planned once (the engine's per-step targets)
        plan = tkv.token_targets(torch.tensor(blk), torch.tensor(slot), NB)
        jp[1] = jkv.pool_write_token(jp[1], jk, jv, jnp.asarray(blk), jnp.asarray(slot))
        tkv.pool_write_token(tp[1], tk, tv, None, None, targets=plan)
        _same(tp[1], jp[1])
    # gathers: out-of-range entries clamp to the last block, never NaN
    tables = np.array([[2, 5, NB], [NB + 7, 0, 7], [NB, NB, NB]], np.int32)
    jg = jkv.pool_gather(jp[0], jnp.asarray(tables))
    tg = tkv.pool_gather(tp[0], torch.from_numpy(tables).long())
    _same(tg, jg)
    assert all(bool(torch.isfinite(a.float()).all()) for a in tg)
    assert all(a.is_contiguous() for a in tg)  # what the decode kernels take
    # appends into the gathered view, at each lane's own row
    k, v = _kv(rng, 3, 1, 2, 8), _kv(rng, 3, 1, 2, 8)
    pos = np.array([5, 0, 11])
    jg = jkv.cache_write_token(jg, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                               jnp.asarray(pos))
    tkv.cache_write_token(tg, *(torch.from_numpy(x).to(torch.bfloat16) for x in (k, v)),
                          torch.from_numpy(pos))
    _same(tg, jg)
    # copy-on-write's block copy, then a compaction permutation, in place
    jp = list(jkv.pool_copy_block(tuple(jp), jnp.int32(5), jnp.int32(3)))
    assert tkv.pool_copy_block(tp, 5, 3) is tp
    for j, t in zip(jp, tp):
        _same(t, j)
    plan = {5: 0, 6: 1, 2: 4}
    jp = jkv.apply_block_permutation(tuple(jp), plan, NB)
    tkv.apply_block_permutation(tp, plan, NB)
    for j, t in zip(jp, tp):
        _same(t, j)


def test_pool_write_then_gather_reproduces_the_contiguous_cache():
    """pool_write_prefill + pool_write_token + pool_gather rebuild a
    contiguous cache exactly, and cache_write_token lands each row at the
    index a fresh gather shows (JAX's own round trip, in the port)."""
    rng = np.random.default_rng(1)
    _, _, _, tp = _pools(False)
    jc, tc = _prefill_cache(rng, False, 8)
    tkv.pool_write_prefill(tp[0], tc, torch.tensor([2, 5]))
    tables = torch.tensor([[2, 5]])
    gathered = tkv.pool_gather(tp[0], tables)
    torch.testing.assert_close(gathered[0], tc[0], rtol=0, atol=0)
    k, v = (torch.from_numpy(_kv(rng, 1, 1, 2, 8)).to(torch.bfloat16) for _ in range(2))
    tkv.pool_write_token(tp[0], k, v, torch.tensor([5]), torch.tensor([2]))
    fresh = tkv.pool_gather(tp[0], tables)
    tkv.cache_write_token(gathered, k, v, torch.tensor([6]))
    for a, b in zip(fresh, gathered):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_int8_writes_take_rows_quantized_once():
    """An int8 pool and its gathered view take ``quantize_q8``'s (q, scale)
    pairs as they take the float rows, bit for bit: the decode step
    quantizes each new row once for both writes."""
    from ddl_tpu_torch.ops.quant import quantize_q8

    rng = np.random.default_rng(4)
    _, _, _, tp = _pools(True)
    blk, slot = torch.tensor([5, NB, 2, 0]), torch.tensor([3, 0, 1, 2])
    k, v = (torch.from_numpy(_kv(rng, 4, 1, 2, 8)).to(torch.bfloat16) for _ in range(2))
    pairs = quantize_q8(k), quantize_q8(v)
    tkv.pool_write_token(tp[0], k, v, blk, slot)
    tkv.pool_write_token(tp[1], *pairs, blk, slot)
    _same(tp[1], tp[0])
    tables = torch.tensor([[2, 5], [0, 7]])
    floats, quantized = (tkv.pool_gather(tp[0], tables) for _ in range(2))
    pos = torch.tensor([3, 6])
    tkv.cache_write_token(floats, k[:2], v[:2], pos)
    tkv.cache_write_token(quantized, *((q[:2], s[:2]) for q, s in pairs), pos)
    for a, b in zip(floats, quantized):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
