"""The port's continuous-batching engine (ddl_tpu_torch/serve/engine.py)
against the JAX package's ``ServeEngine`` and the port's own sequential
``make_lm_generator``, at ``tests/test_serve.py``'s tiny sizes (f32), the
weights from the JAX tree through ``models.convert.lm_params_from_jax``.

Greedy tokens equal to the JAX engine's in the MHA, GQA, window, int8-cache
and int8-weights variants and at ``max_new=1``; every run also equal to
batch-1 sequential decodes through the port's generator, sampled runs too
(each request's seeded generator); the prefix-cache and chunked-prefill
cases of ``tests/test_serve_prefix.py`` equal to JAX and to the same run
without the cache, with the same scheduling statistics; shedding under
pressure with JAX's shed set and reasons; ``defrag``; drain, park and
resume token-identical to the uninterrupted run; the preemption guard;
``precompile``'s grid; and the event stream's kinds and non-timing fields
equal to the JAX engine's on the same run.  On the CPU every kernel wrapper
takes its plain version."""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.models import transformer as jt
from ddl_tpu.obs import EventWriter as JaxEventWriter
from ddl_tpu.obs.events import read_events as jax_read_events
from ddl_tpu.ops.quant import quantize_lm_params as jax_quantize_lm_params
from ddl_tpu.serve.engine import ServeEngine as JaxServeEngine
from ddl_tpu_torch.infer import make_lm_generator
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.models.convert import lm_params_from_jax
from ddl_tpu_torch.obs import EventWriter, events_path, read_events
from ddl_tpu_torch.serve import ServeEngine
from ddl_tpu_torch.serve.engine import ServeDecode

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=8, head_dim=8, d_ff=256,
            compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _lm(**kw):
    """(JAX config, port config, JAX tree, port state_dict) for TINY + kw."""
    kw = {**TINY, **kw}
    jcfg = jt.LMConfig(**kw)
    tree = nn.meta.unbox(jt.TransformerLM(jcfg, None).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return jcfg, tt.LMConfig(**kw), tree, lm_params_from_jax(tree)


def _weights(lm, int8_weights: bool):
    """The JAX tree and the port state_dict to serve; int8 weights are the
    JAX transform's tree, converted as it is."""
    _, _, tree, params = lm
    if not int8_weights:
        return tree, params
    qtree = jax.tree_util.tree_map(np.asarray, jax_quantize_lm_params(tree))
    return qtree, lm_params_from_jax(qtree)


def _clients(n, rng, lo=5, hi=20, new_lo=4, new_hi=12):
    return [(f"c{i}", rng.integers(0, 256, int(rng.integers(lo, hi))).astype(np.int32),
             int(rng.integers(new_lo, new_hi))) for i in range(n)]


def _shared_prefix_clients(n, prefix_len=24, seed=5):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, prefix_len).astype(np.int32)
    return [(f"c{i}", np.concatenate([prefix, rng.integers(0, 256, int(rng.integers(3, 10)))
                                      .astype(np.int32)]), int(rng.integers(4, 9)))
            for i in range(n)]


def _drive(engine_cls, cfg, params, clients, *, seed=3, **kw):
    spec = () if engine_cls is ServeEngine else (None,)
    dev = {"device": "cpu"} if engine_cls is ServeEngine else {}
    kw = {"block_size": 8, "num_blocks": 64, "max_batch": 4, **kw}
    eng = engine_cls(cfg, params, *spec, **dev, **kw)
    for cid, prompt, mn in clients:
        eng.submit(prompt, mn, request_id=cid, rng_seed=seed)
    return eng, {k: np.asarray(v) for k, v in eng.run().items()}


def _port(lm, clients, int8_weights=False, **kw):
    return _drive(ServeEngine, lm[1], _weights(lm, int8_weights)[1], clients, **kw)


def _jax(lm, clients, int8_weights=False, **kw):
    return _drive(JaxServeEngine, lm[0], _weights(lm, int8_weights)[0], clients, **kw)


def _sequential(lm, clients, seed=3, int8_weights=False, **gen_kw):
    """Batch-1 decodes through the port's generator, each request with its
    own generator seeded ``seed`` (the engine's per-request draw)."""
    cfg, params = lm[1], _weights(lm, int8_weights)[1]
    out, gens = {}, {}
    for cid, prompt, mn in clients:
        key = (len(prompt), mn)
        if key not in gens:
            gens[key] = make_lm_generator(cfg, prompt_len=len(prompt), max_new=mn, batch=1,
                                          device="cpu", **gen_kw)
        toks = gens[key](params, torch.from_numpy(prompt[None].astype(np.int64)),
                         torch.Generator().manual_seed(seed))
        out[cid] = toks[0].numpy()
    return out


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for cid in want:
        np.testing.assert_array_equal(got[cid], want[cid], err_msg=cid)


# engine variant -> (config kwargs, engine kwargs, int8 weights)
VARIANTS = {
    "mha": ({}, {}, False),
    "gqa": ({"n_kv_heads": 2}, {}, False),
    "window": ({"attn_window": 6}, {}, False),
    "kv": ({"n_kv_heads": 2}, {"kv_quant": True}, False),
    "kv+w": ({"n_kv_heads": 2}, {"kv_quant": True}, True),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_tokens_match_jax_engine_and_sequential(variant):
    cfg_kw, eng_kw, w8 = VARIANTS[variant]
    lm = _lm(**cfg_kw)
    clients = _clients(8, np.random.default_rng(7))
    eng, got = _port(lm, clients, w8, max_batch=8, **eng_kw)
    _, want = _jax(lm, clients, w8, max_batch=8, **eng_kw)
    _equal(got, want)
    _equal(got, _sequential(lm, clients, int8_weights=w8,
                            kv_quant=eng_kw.get("kv_quant", False)))
    assert all(eng.outcomes[c] == "ok" for c, _, _ in clients)
    assert eng.stats["completed"] == 8
    # every lane retired, every block recycled
    assert eng.allocator.used_blocks == 0 and not eng.busy


def test_max_new_one():
    """A request done straight out of admission waits for the next retire
    and does not stall the batch behind it."""
    lm = _lm()
    clients = [("one", np.arange(6, dtype=np.int32), 1),
               ("few", np.arange(9, dtype=np.int32), 5)]
    eng, got = _port(lm, clients, num_blocks=32, seed=2)
    _equal(got, _jax(lm, clients, num_blocks=32, seed=2)[1])
    _equal(got, _sequential(lm, clients, seed=2))
    assert len(got["one"]) == 1
    assert eng.allocator.used_blocks == 0 and not eng.busy


@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_k=17), dict(temperature=1.3)],
                         ids=["top_k", "temperature"])
def test_sampled_tokens_match_sequential(kw):
    """Each request draws from its own generator seeded with its rng_seed,
    as a batch-1 generator call with that generator draws."""
    lm = _lm()
    clients = _clients(6, np.random.default_rng(3))
    _, got = _port(lm, clients, seed=11, **kw)
    want = _sequential(lm, clients, seed=11, **kw)
    _equal(got, want)
    greedy = _sequential(lm, clients, seed=11)
    assert any(not np.array_equal(got[c], greedy[c]) for c in want)  # it did sample


def test_state_dict_names_are_transformer_lm_s():
    """A port LM state_dict, or lm_params_from_jax of a JAX tree, serves as
    it is: the engine's decode module has TransformerLM's parameter names
    and shapes (no converter)."""
    cfg = _lm()[1]
    with torch.device("meta"):
        serve, lm = ServeDecode(cfg), tt.TransformerLM(cfg)
    assert {k: v.shape for k, v in serve.state_dict().items()} == \
        {k: v.shape for k, v in lm.state_dict().items()}
    assert set(_lm()[3]) == set(lm.state_dict())


def _stats(eng):
    keep = ("submitted", "completed", "shed", "decode_steps", "decode_dispatches",
            "peak_blocks", "prefix_hits", "prefix_hit_tokens", "prefix_inserts",
            "prefill_tokens", "prefill_chunks", "cow_copies")
    return {k: eng.stats[k] for k in keep}


@pytest.mark.parametrize("kw", [{}, dict(temperature=0.8, top_k=17)], ids=["greedy", "sampled"])
def test_shared_prefix_cache_changes_scheduling_not_tokens(kw):
    lm = _lm()
    clients = _shared_prefix_clients(6)
    eng_on, got_on = _port(lm, clients, **kw)
    eng_off, got_off = _port(lm, clients, prefix_cache=False, **kw)
    _equal(got_on, got_off)
    _equal(got_on, _sequential(lm, clients, **kw))
    assert eng_on.stats["prefix_hits"] == 5
    assert eng_on.stats["prefix_hit_tokens"] == 5 * 24
    assert eng_on.stats["prefill_tokens"] < eng_off.stats["prefill_tokens"]
    assert eng_off.stats["prefix_hits"] == 0
    a = eng_on.allocator
    assert a.used_blocks == 0 and a.cached_blocks > 0
    assert a.free_blocks + a.cached_blocks == a.num_blocks
    if not kw:
        jon, jgot_on = _jax(lm, clients)
        _equal(got_on, jgot_on)
        assert _stats(eng_on) == _stats(jon)


def test_fully_cached_prompt_copy_on_write():
    lm = _lm()
    prompt = np.arange(1, 17, dtype=np.int32)  # exactly 2 blocks of 8
    clients = [(f"c{i}", prompt, 5) for i in range(3)]
    eng, got = _port(lm, clients)
    jeng, want = _jax(lm, clients)
    _equal(got, want)
    _equal(got, _port(lm, clients, prefix_cache=False)[1])
    _equal(got, _sequential(lm, clients))
    assert eng.stats["cow_copies"] == 2  # one per repeat request
    assert eng.stats["prefill_tokens"] == 16 + 2 * 8  # each repeat recomputes its last block
    assert _stats(eng) == _stats(jeng)


def test_fully_cached_max_new_one():
    """The fully-cached recompute at max_new=1 sizes the view at exactly
    the reservation; the block-aligned recompute fits it."""
    lm = _lm()
    prompt = np.arange(0, 64, dtype=np.int32)  # exactly 8 blocks of 8
    clients = [("a", prompt, 1), ("b", prompt, 1)]
    eng, got = _port(lm, clients)
    jeng, want = _jax(lm, clients)
    _equal(got, want)
    _equal(got, _port(lm, clients, prefix_cache=False)[1])
    _equal(got, _sequential(lm, clients))
    assert eng.stats["cow_copies"] == 1 and eng.stats["prefix_hits"] == 1
    assert _stats(eng) == _stats(jeng)


def test_chunked_prefill_interleaves_decode():
    """A long prompt under prefill_chunk runs as bounded chunks with decode
    dispatches between them: the short request finishes first."""
    lm = _lm()
    rng = np.random.default_rng(9)
    long_prompt = rng.integers(0, 256, 96).astype(np.int32)
    short_prompt = rng.integers(0, 256, 7).astype(np.int32)
    clients = [("long", long_prompt, 4), ("short", short_prompt, 3)]
    eng = ServeEngine(lm[1], lm[3], block_size=8, num_blocks=64, max_batch=4,
                      prefill_chunk=16, prefix_cache=False, device="cpu")
    for cid, p, mn in clients:
        eng.submit(p, mn, request_id=cid, rng_seed=3)
    short_done_at = long_prefill_done_at = None
    steps = 0
    while eng.step():
        steps += 1
        if short_done_at is None and "short" in eng.results:
            short_done_at = steps
        lane = next((s for s in eng.scheduler.active() if s.request.id == "long"), None)
        if long_prefill_done_at is None and (lane is None or lane.prefill_done):
            long_prefill_done_at = steps
    assert eng.stats["prefill_chunks"] >= 96 // 16
    assert short_done_at is not None and short_done_at < long_prefill_done_at
    got = {k: np.asarray(v) for k, v in eng.results.items()}
    jeng, want = _jax(lm, clients, prefill_chunk=16, prefix_cache=False)
    _equal(got, want)
    _equal(got, _sequential(lm, clients))
    assert _stats(eng) == _stats(jeng)


def test_eviction_under_pool_pressure():
    lm = _lm()
    rng = np.random.default_rng(11)
    clients = [(f"c{i}", rng.integers(0, 256, 20 + 2 * i).astype(np.int32), 4)
               for i in range(6)]
    eng, got = _port(lm, clients, num_blocks=16, max_batch=2)
    jeng, want = _jax(lm, clients, num_blocks=16, max_batch=2)
    _equal(got, want)
    _equal(got, _port(lm, clients, num_blocks=16, max_batch=2, prefix_cache=False)[1])
    a = eng.allocator
    assert a.evictions > 0 and a.used_blocks == 0
    assert a.free_blocks + a.cached_blocks == a.num_blocks
    assert len(eng.prefix) == a.cached_blocks
    assert a.stats() == jeng.allocator.stats()


def test_chunk_bucket_clamped_to_view():
    """A tail whose bucket overruns the gathered view (17 tokens at offset
    40: a 32-row bucket against a 64-row view) is split, not clamped."""
    lm = _lm()
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, 256, 40).astype(np.int32)
    tails = [rng.integers(0, 256, 17).astype(np.int32) for _ in range(2)]
    clients = [("owner", np.concatenate([prefix, tails[0]]), 8),
               ("hit", np.concatenate([prefix, tails[1]]), 8)]
    eng, got = _port(lm, clients, max_batch=2, max_blocks_per_seq=8)
    jeng, want = _jax(lm, clients, max_batch=2, max_blocks_per_seq=8)
    _equal(got, want)
    _equal(got, _port(lm, clients, max_batch=2, max_blocks_per_seq=8, prefix_cache=False)[1])
    assert eng.stats["prefix_hits"] == 1 and eng.stats["prefill_chunks"] >= 2
    assert _stats(eng) == _stats(jeng)


def test_int8_prefix_reuse_is_an_opt_in():
    """An int8 pool stores K/V lossily, so prefix reuse is off by default
    there; cache-off int8 stays exact, and the opt-in hits and stays close."""
    lm = _lm(n_kv_heads=2)
    clients = _shared_prefix_clients(5)
    auto = ServeEngine(lm[1], lm[3], block_size=8, num_blocks=64, max_batch=4,
                       kv_quant=True, device="cpu")
    assert auto.prefix is None
    _, off = _port(lm, clients, kv_quant=True, prefix_cache=False)
    want = _sequential(lm, clients, kv_quant=True)
    _equal(off, want)
    on_eng, on = _port(lm, clients, kv_quant=True, prefix_cache=True)
    assert on_eng.stats["prefix_hits"] >= 4
    agree = sum(int((on[c] == want[c]).sum()) for c in want)
    assert agree / sum(len(want[c]) for c in want) >= 0.7


def test_shed_under_pressure_matches_jax(tmp_path):
    """Overload against a 1-lane engine with a 2-deep queue: the same shed
    set and reasons as JAX under both policies; the rest complete exactly."""
    lm = _lm()
    clients = _clients(5, np.random.default_rng(5), new_lo=3, new_hi=6)

    def drive(cls, writer, read, cfg, params, policy):
        obs = writer(tmp_path / f"{cls.__module__}-{policy}", "shed")
        dev = {"device": "cpu"} if cls is ServeEngine else {}
        spec = () if cls is ServeEngine else (None,)
        eng = cls(cfg, params, *spec, block_size=8, num_blocks=16, max_batch=1, max_queue=2,
                  policy=policy, obs=obs, **dev)
        outcomes = [eng.submit(p, mn, request_id=cid) for cid, p, mn in clients]
        got = {k: np.asarray(v) for k, v in eng.run().items()}
        obs.close()
        sheds = [(e["request_id"], e["reason"], e["policy"])
                 for e in read(obs.path) if e["kind"] == "serve_shed"]
        return outcomes, got, sheds, dict(eng.outcomes), eng.stats["shed"]

    for policy in ("reject", "shed_oldest"):
        port = drive(ServeEngine, EventWriter, read_events, lm[1], lm[3], policy)
        jax_ = drive(JaxServeEngine, JaxEventWriter, jax_read_events, lm[0], lm[2], policy)
        assert port[0] == jax_[0] and port[2] == jax_[2]
        assert port[3] == jax_[3] and port[4] == jax_[4] == 3
        _equal(port[1], jax_[1])
    assert port[0] == ["queued"] * 2 + ["queued_shed_oldest"] * 3


def test_defrag_compacts_and_preserves_tokens():
    """Retiring the middle request fragments the pool; defrag moves live
    blocks on the device and rewrites the tables -- decode continues
    exactly."""
    lm = _lm()
    rng = np.random.default_rng(9)
    short = ("mid", rng.integers(0, 256, 8).astype(np.int32), 3)
    longs = [(f"l{i}", rng.integers(0, 256, 8).astype(np.int32), 12) for i in range(2)]
    eng = ServeEngine(lm[1], lm[3], block_size=4, num_blocks=16, max_batch=3,
                      max_steps_per_dispatch=1, device="cpu")
    for cid, p, mn in (longs[0], short, longs[1]):
        eng.submit(p, mn, request_id=cid)
    while "mid" not in eng.results:
        eng.step()
    assert eng.allocator.fragmentation() > 0.0
    before = [list(s.block_ids) for s in eng.scheduler.active()]
    assert eng.defrag()
    assert eng.allocator.fragmentation() == 0.0
    assert [list(s.block_ids) for s in eng.scheduler.active()] != before
    assert not eng.defrag()  # already packed
    eng.run()
    got = {k: np.asarray(v) for k, v in eng.results.items()}
    clients = [short, *longs]
    _equal(got, _sequential(lm, clients, seed=0))
    _equal(got, _jax(lm, clients, seed=0, block_size=4, num_blocks=16, max_batch=3,
                     max_steps_per_dispatch=1)[1])


def test_drain_tapers_active_and_sheds_queued(tmp_path):
    lm = _lm()
    clients = _clients(3, np.random.default_rng(9), new_lo=3, new_hi=6)
    obs = EventWriter(tmp_path, "drain")
    eng = ServeEngine(lm[1], lm[3], block_size=8, num_blocks=16, max_batch=1, max_queue=4,
                      obs=obs, device="cpu")
    for i, (cid, p, mn) in enumerate(clients):
        assert eng.submit(p, mn, request_id=cid, tenant=f"t{i}") == "queued"
    eng.step()
    assert len(eng.scheduler.active()) == 1
    assert eng.drain("preempt") == {"shed": 2, "parked": 0}
    assert eng.outcomes["c1"] == eng.outcomes["c2"] == "shed:drained"
    assert eng.drain("preempt") == {"shed": 0, "parked": 0}
    assert eng.submit(clients[0][1], 3, request_id="late", tenant="t9") == "rejected"
    assert eng.outcomes["late"] == "shed:draining"
    got = {k: np.asarray(v) for k, v in eng.run().items()}
    obs.close()
    assert sorted(got) == ["c0"] and eng.outcomes["c0"] == "ok"
    _equal(got, _sequential(lm, clients[:1], seed=0))
    assert eng.stats["shed"] == 3
    events = read_events(obs.path)
    drains = [e for e in events if e["kind"] == "serve_drain"]
    assert len(drains) == 1 and drains[0]["shed"] == 2 and drains[0]["active_lanes"] == 1
    sheds = {e["request_id"]: e for e in events
             if e["kind"] == "serve_shed" and e["reason"] == "drained"}
    assert sorted(sheds) == ["c1", "c2"] and sheds["c1"]["tenant"] == "t1"


@pytest.mark.parametrize("kw", [{}, dict(temperature=0.8, top_k=17)], ids=["greedy", "sampled"])
def test_parked_requests_resume_token_identical(tmp_path, kw):
    """Requests parked mid-decode by drain(park=True) complete through
    resume_parked() token-identical to the uninterrupted run: the parked
    generator state replays the draws."""
    lm = _lm()
    clients = [("a", np.arange(1, 9, dtype=np.int32), 12),
               ("b", np.arange(1, 6, dtype=np.int32), 12)]
    obs = EventWriter(tmp_path, "resume")
    eng = ServeEngine(lm[1], lm[3], block_size=8, num_blocks=32, max_batch=2,
                      max_steps_per_dispatch=1, obs=obs, device="cpu", **kw)
    for cid, p, mn in clients:
        eng.submit(p, mn, request_id=cid, rng_seed=5, tenant="t0")
    for _ in range(4):
        eng.step()
    active = eng.scheduler.active()
    assert len(active) == 2 and all(0 < len(s.outputs) < 12 for s in active)
    progress = {s.request.id: len(s.outputs) for s in active}
    assert eng.drain("scale_up", park=True)["parked"] == 2
    assert eng.outcomes["a"] == "parked:scale_up" and 0 < len(eng.results["a"]) < 12
    assert eng.allocator.used_blocks == 0 and not eng.busy
    assert eng.resume_parked() == {"resumed": 2, "rejected": 0}
    assert not eng.draining and eng.drain_reason is None
    got = {k: np.asarray(v) for k, v in eng.run().items()}
    obs.close()
    uninterrupted = _port(lm, clients, seed=5, num_blocks=32, max_batch=2,
                          max_steps_per_dispatch=1, **kw)[1]
    _equal(got, uninterrupted)
    _equal(got, _sequential(lm, clients, seed=5, **kw))
    assert all(eng.outcomes[c] == "ok" for c in got)
    resumes = {e["request_id"]: e for e in read_events(obs.path) if e["kind"] == "serve_resume"}
    for cid, n in progress.items():
        assert resumes[cid]["resumed_tokens"] == n and resumes[cid]["remaining"] == 12 - n
        assert resumes[cid]["tenant"] == "t0"


def test_preempt_guard_trips_drain_in_step():
    class Guard:
        requested = False

    lm = _lm()
    guard = Guard()
    eng = ServeEngine(lm[1], lm[3], block_size=8, num_blocks=16, max_batch=1, max_queue=4,
                      guard=guard, device="cpu")
    clients = _clients(2, np.random.default_rng(3), new_lo=3, new_hi=5)
    for cid, p, mn in clients:
        eng.submit(p, mn, request_id=cid)
    eng.step()
    assert not eng.draining
    guard.requested = True
    eng.step()
    assert eng.draining and eng.drain_reason == "preempt"
    assert eng.outcomes["c1"] == "shed:drained"
    got = eng.run()
    assert sorted(got) == ["c0"] and eng.outcomes["c0"] == "ok"


def test_precompile_covers_the_grid_and_warmup_leaves_no_trace():
    """Every reachable shape runs once: buckets {8, 16}, K {1, 2} x widths
    {1, 2, 4}, the chunk grid (mid + final) x {8, 16}; then a request
    inside the envelope takes no shape's first run."""
    lm = _lm()
    eng = ServeEngine(lm[1], lm[3], block_size=8, num_blocks=32, max_batch=2,
                      max_steps_per_dispatch=2, device="cpu")
    assert eng.precompile(12, 8) == {"prefill": 2, "decode": 6, "chunk": 4}
    assert eng.precompile(12, 8) == {"prefill": 0, "decode": 0, "chunk": 0}
    assert all(not t.any() for layer in eng.pools for t in layer)  # every write dropped
    eng.submit(np.arange(1, 11, dtype=np.int32), 8, request_id="r")
    eng.run()
    assert eng.stats["prefill_first_runs"] == eng.stats["decode_first_runs"] == 0
    assert eng.request_log[-1]["warm"]
    fresh = ServeEngine(lm[1], lm[3], block_size=8, num_blocks=32, max_batch=2, device="cpu")
    fresh.warmup(8, max_new=2)
    assert fresh.stats["submitted"] == fresh.stats["completed"] == 0
    assert "_warmup" not in fresh.results and not fresh.request_log
    fresh.submit(np.arange(1, 9, dtype=np.int32), 3, request_id="r")
    fresh.run()
    assert fresh.stats["prefill_first_runs"] == 1  # the warmup's own


TIMING = {"ts", "mono", "run", "host", "dur", "queue_delay", "ttft", "tok_per_s", "t0", "t1",
          "compiled", "warm", "repoch", "step"}


def _comparable(events):
    return [(e["kind"], {k: v for k, v in e.items() if k not in TIMING | {"kind"}})
            for e in events if not e["kind"].startswith("hbm_")]


def test_event_stream_matches_jax(tmp_path):
    """The same clients through both engines: the same event kinds in the
    same order with the same non-timing fields (the HBM ledger's events,
    whose plans follow each backend's programs, are held in
    test_torch_obs_hbm.py; the first-run flags mean compiles there)."""
    lm = _lm()
    clients = _shared_prefix_clients(4) + _clients(3, np.random.default_rng(2))
    kw = dict(block_size=8, num_blocks=32, max_batch=2, max_steps_per_dispatch=4,
              prefill_chunk=16, scenario="mixed")
    obs = EventWriter(tmp_path / "port", "ev")
    jobs = JaxEventWriter(tmp_path / "jax", "ev")
    eng = ServeEngine(lm[1], lm[3], obs=obs, device="cpu", **kw)
    jeng = JaxServeEngine(lm[0], lm[2], None, obs=jobs, **kw)
    for e in (eng, jeng):
        for i, (cid, p, mn) in enumerate(clients):
            e.submit(p, mn, request_id=cid, tenant=("acme", "bulk")[i % 2],
                     priority_class="interactive" if i % 3 == 0 else None)
        e.run()
    obs.close()
    jobs.close()
    got = _comparable(read_events(events_path(tmp_path / "port", "ev")))
    want = _comparable(jax_read_events(jobs.path))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert got == want
    kinds = {k for k, _ in got}
    assert {"serve_admit", "serve_retire", "decode", "kv_pool_stats", "prefix_hit",
            "prefix_insert", "trace_span"} <= kinds


def test_device_none_means_cuda():
    """The engine and serve-bench run on CUDA unless the caller asks for the
    CPU, as make_lm_generator does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    lm = _lm()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(lm[1], lm[3], block_size=8, num_blocks=16, max_batch=1)
    from ddl_tpu_torch.serve import bench

    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--clients", "1"])
