"""The emit half of the HBM ledger (``ddl_tpu_torch/obs/hbm.py``) and its
fault drills against the JAX package's (``tests/test_obs_hbm.py``,
``tests/test_fault_tolerance.py``): ``live_sample``, ``plan_program``
and ``dump_oom`` emit the same kinds with the same fields and category
sums; ``leak@step`` books into the synthetic watermark and trips the
port's ``hbm_growth`` detector; ``nan@grad`` is consumed when the LM step
is built, so the rollback's rebuild replays clean; the trainers and the
serving engine stamp the events.  On the CPU the watermark is synthetic
in both packages."""

import numpy as np
import pytest
import torch

from ddl_tpu.obs import hbm as jax_hbm
from ddl_tpu.obs.anomaly import HBMGrowthDetector as JaxHBMGrowthDetector
from ddl_tpu.obs.events import EventWriter as JaxEventWriter
from ddl_tpu.obs.events import read_events as jax_read_events
from ddl_tpu.utils import faultinject as jax_faultinject
from ddl_tpu_torch.obs import EventWriter, HBMGrowthDetector, events_path, read_events
from ddl_tpu_torch.obs import hbm
from ddl_tpu_torch.utils import faultinject

# envelope fields that differ between any two writers
ENVELOPE = {"ts", "mono", "run", "seq"}


@pytest.fixture(autouse=True)
def _clean_injectors():
    faultinject.deactivate()
    jax_faultinject.deactivate()
    yield
    faultinject.deactivate()
    jax_faultinject.deactivate()


def _body(e: dict) -> dict:
    return {k: v for k, v in e.items() if k not in ENVELOPE}


def test_live_sample_matches_jax(tmp_path):
    """test_obs_hbm.py:158's sample: the same event, synthetic on the CPU,
    the watermark the tracked sum; the categories sum to it."""
    kw = dict(params_bytes=1000, opt_bytes=2000, kv_free_bytes=500, step=3)
    got = hbm.live_sample(EventWriter(tmp_path / "port", "rt"), **kw)
    want = jax_hbm.live_sample(JaxEventWriter(tmp_path / "jax", "rt", host=0), **kw)
    assert _body(got) == _body(want)
    assert got["synthetic"] is True and got["watermark"] == 3500
    assert sum(hbm.sample_categories(got).values()) == got["watermark"]
    assert hbm.sample_categories(got) == jax_hbm.sample_categories(want)
    assert hbm.live_sample(None, **kw) is None
    ctx = hbm.live_sample(EventWriter(tmp_path / "port", "ctx"), context="restore")
    assert ctx["context"] == "restore" and ctx["watermark"] == 0


def test_plan_program_aval_matches_jax(tmp_path):
    """test_obs_hbm.py:203's aval budget: argument and output bytes from
    the shapes, temp and code null; the port's dispatch returns the
    program's output.  Off a card ``full`` mode is the same shape
    arithmetic (no allocator to read), where the JAX package reads XLA's
    memory analysis."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((64,), jnp.float32)
    want = jax_hbm.plan_program(JaxEventWriter(tmp_path / "jax", "aval", host=0), "inc",
                                jax.jit(lambda v: v + 1), (x,), mode="aval")
    w = EventWriter(tmp_path / "port", "aval")
    out, got = hbm.plan_program(w, "inc", lambda v: v + 1, (torch.zeros(64),), mode="aval")
    assert torch.equal(out, torch.ones(64))
    assert _body(got) == _body(want)
    assert got["analysis"] == "aval" and got["argument_bytes"] == got["output_bytes"] == 256
    _, full = hbm.plan_program(w, "inc_full", lambda v: v + 1, (torch.zeros(64),),
                               device="cpu")
    assert {k: full[k] for k in hbm.PLAN_FIELDS} == {k: got[k] for k in hbm.PLAN_FIELDS}
    # state updated in place counts among the arguments once, and as aliased
    state = {"w": torch.zeros(8, 8)}
    _, r = hbm.plan_program(w, "sgd", lambda s, g: s["w"].sub_(g), (state, torch.ones(8, 8)),
                            mode="aval", resident=state)
    assert (r["argument_bytes"], r["alias_bytes"], r["output_bytes"]) == (512, 256, 256)


def test_plan_program_propagates_the_program_error(tmp_path):
    def boom():
        raise ValueError("the program's own error")

    with pytest.raises(ValueError, match="own error"):
        hbm.plan_program(EventWriter(tmp_path, "e"), "boom", boom, mode="aval")


def test_dump_oom_matches_jax(tmp_path):
    """test_obs_hbm.py:158's forensic dump and :223's classifier: the same
    fields, the failure text, the plans this process emitted, and resident
    tensors grouped by (shape, dtype) (the port's are the CPU tensors Python
    holds)."""
    err = RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating")
    for exc in (err, ValueError("shape mismatch"),
                RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
                MemoryError("failed to allocate 8 bytes")):
        assert hbm.is_oom_error(exc) == jax_hbm.is_oom_error(exc), exc
    assert hbm.is_oom_error(torch.OutOfMemoryError("allocator says no"))
    assert not hbm.is_oom_error(KeyError("k"))
    w = EventWriter(tmp_path / "port", "oom")
    hbm.plan_program(w, "double", lambda v: v * 2, (torch.zeros(16, 16),), mode="aval")
    keep = torch.zeros(32, 32)  # a resident tensor the dump must find
    got = hbm.dump_oom(w, err, step=3, params_bytes=1000, opt_bytes=2000, device="cpu")
    jw = JaxEventWriter(tmp_path / "jax", "oom", host=0)
    want = jax_hbm.dump_oom(jw, err, step=3, params_bytes=1000, opt_bytes=2000)
    assert got.keys() == want.keys()
    for k in ("kind", "step", "error", "params_bytes", "opt_bytes", "watermark", "limit"):
        assert got[k] == want[k], k
    assert got["plans"]["double"]["analysis"] == "aval"
    # the float32 group: tensors another test file of the same process holds
    # (int8 (32, 32) kernels, say) form groups of their own
    assert any(b["shape"] == [32, 32] and b["dtype"] == "float32" and b["count"] >= 1
               for b in got["buffers"])
    assert len(got["buffers"]) <= hbm.MAX_OOM_BUFFERS
    del keep
    assert hbm.dump_oom(None, err) is None


def test_tree_shard_bytes_counts_each_tensor_once():
    """test_obs_hbm.py:265: bytes per tensor of a tree, None for an empty
    one; a tensor seen twice counts once; a module counts its
    parameters."""
    a, b = torch.zeros(8, 8), torch.zeros(4)
    assert hbm.tree_shard_bytes({"a": a, "b": b}) == 8 * 8 * 4 + 4 * 4
    assert hbm.tree_shard_bytes([a, (a, {"b": b})]) == 8 * 8 * 4 + 4 * 4
    assert hbm.tree_shard_bytes(None) is None and hbm.tree_shard_bytes({}) is None
    lin = torch.nn.Linear(3, 2)
    assert hbm.tree_shard_bytes(lin) == hbm.tree_shard_bytes(lin.parameters()) == 8 * 4


def test_leak_books_into_the_synthetic_watermark_as_jax(tmp_path):
    """test_obs_hbm.py's leak drill: ``leak@step:2:1`` holds 1 MB from step
    2, the synthetic watermark carries it, ``deactivate`` releases it; the
    same numbers from both packages."""
    seen = []
    for pkg, mod, writer in ((faultinject, hbm, EventWriter(tmp_path / "p", "leak")),
                             (jax_faultinject, jax_hbm,
                              JaxEventWriter(tmp_path / "j", "leak", host=0))):
        pkg.activate("leak@step:2:1")
        marks = []
        for step in range(4):
            pkg.check_step(step)
            marks.append(mod.live_sample(writer, params_bytes=100, opt_bytes=200)["watermark"])
        seen.append((marks, pkg.leaked_bytes()))
        pkg.deactivate()
        assert pkg.leaked_bytes() == 0
    assert seen[0] == seen[1] == ([300, 300, 300 + (1 << 20), 300 + (1 << 20)], 1 << 20)


TINY_LM = dict(vocab_size=256, d_model=32, n_layers=1, n_heads=4, head_dim=8, d_ff=64,
               compute_dtype="float32")


def _lm_trainer(root, **run_kw):
    from ddl_tpu_torch.models.transformer import LMConfig
    from ddl_tpu_torch.parallel.sharding import LMMeshSpec
    from ddl_tpu_torch.train import LMRunConfig, LMTrainer, Optimizer

    run = LMRunConfig(**{"batch": 4, "seq_len": 16, "log_every": 1, "job_id": "hbm",
                         "log_dir": f"{root}/logs", "checkpoint_dir": f"{root}/ckpt",
                         **run_kw})
    return LMTrainer(LMConfig(**TINY_LM), LMMeshSpec(), lambda p: Optimizer(p, 1e-3), run,
                     seed=0, device="cpu")


def test_leak_grows_the_sampled_watermark_and_trips_hbm_growth(tmp_path):
    """A leak of 1 MB at each of 9 steps under the LM trainer (a period a
    step): one ``hbm_sample`` a period whose synthetic watermark grows by
    each leak over the tracked parameter and optimizer bytes, which the
    port's ``hbm_growth`` detector flags as the JAX package's does; the
    trainer also stamps one ``hbm_plan`` for its train step."""
    faultinject.activate(",".join(f"leak@step:{s}:1" for s in range(9)))
    t = _lm_trainer(tmp_path, steps=9, save_every=0)
    t.train()
    events = read_events(events_path(tmp_path / "logs", "hbm"))
    samples = [e for e in events if e["kind"] == "hbm_sample"]
    assert [e["step"] for e in samples] == list(range(1, 10))
    for i, e in enumerate(samples):
        assert e["synthetic"] is True
        assert e["params_bytes"] == hbm.tree_shard_bytes(t.state.model.parameters())
        assert e["opt_bytes"] == t.state.optimizer.state_bytes() == 2 * e["params_bytes"]
        assert e["watermark"] == e["params_bytes"] + e["opt_bytes"] + (i + 1) * (1 << 20)
    found = []
    for det in (HBMGrowthDetector(), JaxHBMGrowthDetector()):
        found.append([det.observe(e["watermark"]) for e in samples])
    assert str(found[0]) == str(found[1])
    assert found[0][-1]["type"] == "hbm_growth" and found[0][-1]["growth_frac"] > 0.05
    plans = [e for e in events if e["kind"] == "hbm_plan"]
    assert [p["label"] for p in plans] == ["train_step"]
    assert plans[0]["alias_bytes"] == hbm.tree_shard_bytes(t.state.model.state_dict())
    assert plans[0]["argument_bytes"] == plans[0]["alias_bytes"] + 2 * 4 * 16 * 8


def test_nan_grad_recovers_as_jax(tmp_path):
    """tests/test_fault_tolerance.py:701-730 on the port's LM trainer:
    ``nan@grad:5`` makes step 5's update non-finite, the next window's loss
    goes NaN, ``nan_policy="recover"`` rolls back to the step-4 snapshot,
    and the grace window's rebuild of the step finds the fault consumed,
    so the replay ends at step 8 with finite weights; the rollback event
    is the JAX trainer's."""
    from tests.test_torch_lm_checkpoint import _jax_trainer

    assert faultinject.activate("nan@grad:7") and faultinject.traced_nan_step() == 7
    assert faultinject.traced_nan_step() is None
    kw = dict(steps=8, save_every=4, eval_every=0, log_every=1, nan_policy="recover",
              nan_max_consecutive=1, nan_grace_scale=0.1, nan_grace_periods=1, job_id="nan")
    jax_faultinject.activate("nan@grad:5")
    jax_t = _jax_trainer(str(tmp_path), **kw)
    jax_t.train()
    faultinject.activate("nan@grad:5")
    t = _lm_trainer(tmp_path / "port", **{k: v for k, v in kw.items() if k != "log_every"})
    t.train()
    assert t.state.step == int(jax_t.state.step) == 8
    assert t.recovery.rollbacks == jax_t.recovery.rollbacks == 1
    assert t.update_scale == jax_t.update_scale == 1.0
    assert all(torch.isfinite(p).all() for p in t.state.model.parameters())
    got = [(e["step"], e["period"], e["resumed_at"])
           for e in read_events(events_path(tmp_path / "port" / "logs", "nan"))
           if e["kind"] == "rollback"]
    want = [(e["step"], e["period"], e["resumed_at"])
            for e in jax_read_events(events_path(tmp_path / "jax" / "logs", "nan"))
            if e["kind"] == "rollback"]
    assert got == want and len(got) == 1


def test_densenet_trainer_stamps_plan_and_samples(tmp_path, monkeypatch):
    """The DenseNet Trainer: an ``hbm_plan`` over its first train step
    (the model's state aliased), an ``hbm_sample`` a period with this
    rank's parameter and optimizer bytes; ``DDL_HBM_PLAN=off`` drops the
    plan."""
    from ddl_tpu_torch.config import preset
    from ddl_tpu_torch.train import Trainer

    def run(job):
        monkeypatch.setenv("DDL_JOB_ID", job)
        cfg = preset("single", **{
            "model.growth_rate": "4", "model.block_config": "[2,2]",
            "model.num_init_features": "8", "model.bn_size": "2", "data.image_size": "16",
            "data.num_workers": "0", "data.dataset_dir": "", "data.synthetic_num_train": "16",
            "data.synthetic_num_test": "8", "data.global_batch_size": "8",
            "data.eval_batch_size": "8", "train.max_epochs": "2",
            "train.log_dir": str(tmp_path / "logs"), "train.checkpoint_dir": str(tmp_path / "ck"),
            "train.auto_resume": "false"})
        t = Trainer(cfg, device="cpu")
        t.train()
        return t, read_events(events_path(tmp_path / "logs", job))

    t, events = run("cnn-hbm")
    plans = [e for e in events if e["kind"] == "hbm_plan"]
    assert len(plans) == 1 and plans[0]["label"] == "train_step"
    assert plans[0]["alias_bytes"] == hbm.tree_shard_bytes(t.model.state_dict())
    samples = [e for e in events if e["kind"] == "hbm_sample"]
    assert [e["step"] for e in samples] == [0, 1]
    assert all(e["opt_bytes"] == t.optimizer.state_bytes() and
               e["params_bytes"] == hbm.tree_shard_bytes(t.model.parameters()) for e in samples)
    monkeypatch.setenv("DDL_HBM_PLAN", "off")
    _, events = run("cnn-off")
    assert not [e for e in events if e["kind"] == "hbm_plan"]
    assert [e["step"] for e in events if e["kind"] == "hbm_sample"] == [0, 1]


def test_serving_samples_split_the_pool_as_jax(tmp_path):
    """The serving engine's ``hbm_sample`` beside each ``kv_pool_stats``
    (ddl_tpu/serve/engine.py:885-920): the weights and the pool split
    into cached, private and free blocks, the three summing to the whole
    pool, the same bytes in the same order as the JAX engine's; and one
    ``hbm_plan`` per program shape's first run."""
    from ddl_tpu.obs.events import read_events as jread
    from ddl_tpu.serve.engine import ServeEngine as JaxServeEngine
    from ddl_tpu_torch.serve.engine import ServeEngine
    from tests.test_torch_serve import _lm, _shared_prefix_clients

    lm = _lm()
    clients = _shared_prefix_clients(4)
    kw = dict(block_size=8, num_blocks=32, max_batch=2, max_steps_per_dispatch=4)
    obs = EventWriter(tmp_path / "port", "sv")
    jobs = JaxEventWriter(tmp_path / "jax", "sv", host=0)
    eng = ServeEngine(lm[1], lm[3], obs=obs, device="cpu", **kw)
    jeng = JaxServeEngine(lm[0], lm[2], None, obs=jobs, **kw)
    for e in (eng, jeng):
        for cid, p, mn in clients:
            e.submit(p, mn, request_id=cid)
        e.run()
    obs.close()
    jobs.close()
    got = read_events(events_path(tmp_path / "port", "sv"))
    want = jread(jobs.path)
    cats = ("kv_cached_bytes", "kv_private_bytes", "kv_free_bytes")

    def samples(events):
        return [tuple(e[c] for c in cats) for e in events if e["kind"] == "hbm_sample"]

    assert samples(got) and samples(got) == samples(want)
    pool = hbm.tree_shard_bytes(eng.pools)
    assert all(sum(s) == pool for s in samples(got))
    assert len(samples(got)) == sum(e["kind"] == "kv_pool_stats" for e in got)
    labels = [e["label"] for e in got if e["kind"] == "hbm_plan"]
    assert labels and len(labels) == len(set(labels))
    assert {"serve_prefill", "serve_decode"} <= {label.split("_b")[0].split("_k")[0]
                                                  for label in labels}
