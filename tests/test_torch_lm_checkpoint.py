"""Snapshots, exact resume, recovery, profiling and the event stream of the
port's LM trainer (ddl_tpu_torch/train/lm_trainer.py) against the JAX
package's ``LMTrainer``, both started from the same weights (the JAX
trainer's initial parameters through ``lm_params_from_jax``): the period
boundaries with ``save_every``; a ``preempt@step`` run resumed by
auto-resume writes the same snapshot steps and manifest cursors and logs
the same per-window losses; the resumed run is bit-equal to the port's own
uninterrupted run; explicit and automatic resume past a
``corrupt_ckpt@save`` snapshot; ``keep_snapshots`` with the best
``val_ppl`` protected; ``nan_policy="recover"``'s rollback; the
``profile_dir`` trace.  Then ``checkpoint.load_params``, the params-only
restore, with the lm_head orientation cases of
``tests/test_lm_checkpoint.py``.

f32 on both sides; losses within ``test_torch_lm_train.LOSS_RTOL``
(1e-5 relative: the same math in another summation order)."""

import csv
import functools
import warnings
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from ddl_tpu import checkpoint as jax_ckpt
from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
from ddl_tpu.obs.events import read_events as jax_read_events
from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
from ddl_tpu.train.lm_trainer import LMRunConfig as JaxRunConfig
from ddl_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from ddl_tpu.utils import faultinject as jax_faultinject
from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.models.convert import lm_params_from_jax
from ddl_tpu_torch.models.transformer import LMConfig
from ddl_tpu_torch.obs import events_path
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import make_lm_step_fns
from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer
from ddl_tpu_torch.train.state import Optimizer
from ddl_tpu_torch.utils import faultinject
from tests.test_torch_lm_train import LOSS_RTOL, PARAM_ATOL

TINY = dict(vocab_size=256, d_model=32, n_layers=1, n_heads=4, head_dim=8, d_ff=64,
            compute_dtype="float32")
# log 3, eval 4, save 5: boundaries 3, 4, 5, 6, 8, 9, 10, 12, 14
RUN = dict(batch=4, seq_len=16, steps=14, log_every=3, eval_every=4, eval_frac=0.25,
           save_every=5)
PREEMPT_STEP = 6  # the first step of the window (6, 8]
JOB = "lm-exact"
# JAX-only event kinds the port does not emit: XLA's persistent compile
# cache (not ported)
DEFERRED_KINDS = {"compile_cache"}


def _adamw(params):
    """optax.adamw(1e-3): decoupled weight decay 1e-4 (optax's default)."""
    return Optimizer(params, 1e-3, weight_decay=1e-4)


@pytest.fixture(autouse=True)
def _clean_injectors():
    faultinject.deactivate()
    jax_faultinject.deactivate()
    yield
    faultinject.deactivate()
    jax_faultinject.deactivate()


@functools.cache
def _corpus(root: str) -> str:
    """2000 seeded bytes: 124 windows of 16+1 tokens, the last 31 held out."""
    path = Path(root) / "corpus.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(np.random.default_rng(7).integers(0, 256, 2000, dtype=np.uint8).tobytes())
    return str(path)


def _jax_trainer(root, job=JOB, cfg=TINY, **run_kw):
    run = JaxRunConfig(**{**RUN, "checkpoint_dir": f"{root}/jax/ckpt",
                          "log_dir": f"{root}/jax/logs", "job_id": job, **run_kw})
    return JaxLMTrainer(JaxLMConfig(**cfg), JaxMeshSpec(), optax.adamw(1e-3), run,
                        jax.random.key(0))


@functools.cache
def _jax_params0(cfg_items: tuple) -> dict:
    """The JAX trainer's initial parameters as a port ``state_dict``."""
    run = JaxRunConfig(**{**RUN, "log_dir": None})
    t = JaxLMTrainer(JaxLMConfig(**dict(cfg_items)), JaxMeshSpec(), optax.adamw(1e-3), run,
                     jax.random.key(0))
    return lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(t.state.params)))


def _port_trainer(root, job=JOB, cfg=TINY, **run_kw) -> LMTrainer:
    """A port trainer; a fresh start takes the JAX trainer's initial
    weights, a resumed one keeps what it restored."""
    run = LMRunConfig(**{**RUN, "checkpoint_dir": f"{root}/port/ckpt",
                         "log_dir": f"{root}/port/logs", "job_id": job, **run_kw})
    t = LMTrainer(LMConfig(**cfg), LMMeshSpec(), _adamw, run, seed=0, device="cpu")
    if t.state.step == 0:
        t.state.model.load_state_dict(_jax_params0(tuple(sorted(cfg.items()))))
    return t


def _preempt_and_resume(make, pkg) -> dict:
    """``make()`` under ``preempt@step``, then a second ``make()`` that
    resumes by itself; what both did."""
    pkg.activate(f"preempt@step:{PREEMPT_STEP}")
    first = make()
    first.train()
    pkg.deactivate()
    second = make()
    resumed = (second._start_step, second.periods_run, second._resume_offset)
    second.train()
    return {"preempted": first.preempted, "resumed": resumed, "final": second}


@functools.cache
def _runs(root: str) -> dict:
    """Both packages' preempt-and-resume runs on the corpus, and the port's
    uninterrupted run (cached: several tests read them)."""
    corpus = _corpus(root)
    return {
        "jax": _preempt_and_resume(lambda: _jax_trainer(root, corpus=corpus), jax_faultinject),
        "port": _preempt_and_resume(lambda: _port_trainer(root, corpus=corpus), faultinject),
        "straight": _port_trainer(root, job="lm-straight", corpus=corpus),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lm_ckpt"))
    out = _runs(root)
    out["straight"].train()
    return root, out


def _rows(root, side, metric, job=JOB) -> list[tuple[int, float]]:
    with open(Path(root) / side / "logs" / "by_job_id" / job / f"{metric}.csv", newline="") as f:
        return [(int(r[5]), float(r[6])) for r in csv.reader(f)]


def _assert_rows_close(got, want):
    assert [e for e, _ in got] == [e for e, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=LOSS_RTOL)


@pytest.mark.parametrize("save_every", [5, 7, 0])
def test_period_boundaries_with_save_every_match_jax(tmp_path, save_every):
    want = _jax_trainer(tmp_path, save_every=save_every)
    got = _port_trainer(tmp_path, save_every=save_every)
    assert got._boundaries == want._boundaries
    assert got.num_periods == want.num_periods
    for p in range(got.num_periods):
        assert got._period_bounds(p) == want._period_bounds(p)
        assert got.snapshot_due(p) == want.snapshot_due(p)
        assert got.log_due(p) == want.log_due(p)
    if save_every == 5:
        assert got._boundaries == [3, 4, 5, 6, 8, 9, 10, 12, 14]
    # without a checkpoint directory the save cadence adds no boundary
    bare = _port_trainer(tmp_path, job="bare", checkpoint_dir=None)
    assert bare._boundaries == [3, 4, 6, 8, 9, 12, 14]


def test_preempted_run_writes_the_jax_snapshots_and_cursors(runs):
    root, out = runs
    assert out["port"]["preempted"] and out["jax"]["preempted"]
    got = ckpt.snapshot_epochs(f"{root}/port/ckpt", JOB)
    want = jax_ckpt.snapshot_epochs(f"{root}/jax/ckpt", JOB)
    assert got == want
    assert PREEMPT_STEP + 1 in got and 10 in got
    for step in got:
        cursor = ckpt.read_cursor(f"{root}/port/ckpt", JOB, step)
        assert cursor == jax_ckpt.read_cursor(f"{root}/jax/ckpt", JOB, step)
        assert {"step", "shuffle_epoch", "epoch_pos"} <= cursor.keys()
        assert cursor["step"] == step
    # the preemption save: window 4 (6, 8], one step in
    assert ckpt.read_cursor(f"{root}/port/ckpt", JOB, PREEMPT_STEP + 1)["offset"] == 1


def test_resume_restarts_where_jax_does(runs):
    _, out = runs
    # step 7, window 4 (6, 8], one step of it done
    assert out["port"]["resumed"] == out["jax"]["resumed"] == (PREEMPT_STEP + 1, 4, 1)
    assert out["port"]["final"].state.step == int(out["jax"]["final"].state.step) == RUN["steps"]


def test_preempted_and_resumed_losses_match_jax(runs):
    root, _ = runs
    for metric in ("loss", "val_loss", "val_ppl"):
        _assert_rows_close(_rows(root, "port", metric), _rows(root, "jax", metric))


def test_resumed_run_is_bit_equal_to_the_uninterrupted_one(runs):
    root, out = runs
    resumed, straight = out["port"]["final"], out["straight"]
    # the resumed job's CSV holds both legs; the windows after the resume
    # are logged once in each job
    got = dict(_rows(root, "port", "loss"))
    want = dict(_rows(root, "port", "loss", job="lm-straight"))
    assert got == want
    for a, b in ((resumed.state.model.state_dict(), straight.state.model.state_dict()),
                 (resumed.snapshot_state()["optimizer"]["inner"]["state"],
                  straight.snapshot_state()["optimizer"]["inner"]["state"])):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                assert all(torch.equal(a[k][n], b[k][n]) for n in a[k]), k
            else:
                assert torch.equal(a[k], b[k]), k
    assert resumed.state.optimizer.count == straight.state.optimizer.count == RUN["steps"]


def _kinds_and_keys(events) -> dict:
    out = {}
    for e in events:
        keys = set(e)
        if e["kind"] == "span":
            keys.add(f"span:{e['name']}")
        out.setdefault(e["kind"], set()).update(keys)
    return out


def test_event_stream_has_the_jax_kinds_and_keys(runs):
    """The port's stream, read by the JAX ``read_events``: the same kinds
    (less the deferred ones), keys and span names; the same period events
    and restore; each full window with its data_wait/step/fence phases."""
    root, _ = runs
    got = jax_read_events(events_path(f"{root}/port/logs", JOB))
    want = jax_read_events(events_path(f"{root}/jax/logs", JOB))
    got_kinds, want_kinds = _kinds_and_keys(got), _kinds_and_keys(want)
    assert set(want_kinds) - set(got_kinds) <= DEFERRED_KINDS
    assert {"hbm_plan", "hbm_sample"} <= set(got_kinds)
    for kind in DEFERRED_KINDS:
        want_kinds.pop(kind, None)
    assert got_kinds == want_kinds
    periods = [(e["period"], e["steps"], e["offset"]) for e in got if e["kind"] == "period"]
    assert periods == [(e["period"], e["steps"], e["offset"])
                       for e in want if e["kind"] == "period"]
    assert (4, 1, 0) in periods and (4, 1, 1) in periods  # preempted, then resumed
    restore = [(e["epoch"], e["period"], e["offset"]) for e in got
               if e["kind"] == "snapshot_restore"]
    assert restore == [(e["epoch"], e["period"], e["offset"]) for e in want
                       if e["kind"] == "snapshot_restore"] == [(PREEMPT_STEP + 1, 4, 1)]
    for e in (e for e in got if e["kind"] == "period" and e["steps"] > 1):
        assert {"data_wait", "step", "fence"} <= e["phases"].keys()


def _resume_decisions(make, corrupt, pkg) -> tuple:
    """Train 6 steps, saving every 2 with the 3rd save (step 6) corrupted;
    then where auto-resume, resume_step=2 and a fresh start begin, and
    what an explicit resume of the corrupt step raises."""
    pkg.activate("corrupt_ckpt@save:3")
    make(steps=6).train()
    pkg.deactivate()
    auto = make(steps=8)._start_step
    explicit = make(steps=8, resume_step=2)._start_step
    fresh = make(steps=8, auto_resume=False)._start_step
    with pytest.raises(corrupt):
        make(steps=8, resume_step=6)
    return auto, explicit, fresh


def test_resume_explicit_and_auto_skip_a_corrupt_snapshot_as_jax(tmp_path):
    kw = dict(save_every=2, eval_every=0, log_dir=None, job_id="lm-corrupt")
    got = _resume_decisions(functools.partial(_port_trainer, tmp_path, **kw),
                            ckpt.SnapshotCorruptError, faultinject)
    want = _resume_decisions(functools.partial(_jax_trainer, tmp_path, **kw),
                             jax_ckpt.SnapshotCorruptError, jax_faultinject)
    assert got == want == (4, 2, 0)


def test_restored_state_is_bit_equal_to_the_snapshot(tmp_path):
    kw = dict(save_every=4, eval_every=0, log_dir=None, job_id="lm-restore")
    first = _port_trainer(tmp_path, steps=4, **kw)
    first.train()
    saved = {k: v.clone() for k, v in first.state.model.state_dict().items()}
    moments = {i: {k: v.clone() for k, v in s.items()}
               for i, s in first.state.optimizer.inner.state_dict()["state"].items()}
    again = _port_trainer(tmp_path, steps=8, **kw)
    assert again.state.step == again._start_step == 4
    assert again.state.optimizer.count == 4
    for k, v in again.state.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for i, s in again.state.optimizer.inner.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, moments[i][k]), (i, k)
            assert k != "step" or v.device.type == "cpu"
    # in place: the optimizer still updates the model's own parameters
    params = list(again.state.model.parameters())
    assert all(p is q for p, q in zip(params, again.state.optimizer.params))


@pytest.mark.parametrize("keep", [1, 2])
def test_keep_snapshots_leaves_the_jax_steps_and_the_best(tmp_path, keep):
    """GC after each save keeps the newest ``keep`` and never the best
    ``val_ppl`` one (a fake eval makes step 2 the best), as JAX's GC."""
    kw = dict(steps=10, save_every=2, eval_every=2, log_every=2, log_dir=None,
              keep_snapshots=keep, job_id=f"lm-gc{keep}")

    def run(trainer):
        vals = iter([1.0] + [9.0] * 10)

        def fake_eval(period):
            if trainer._period_bounds(period)[1] % 2:
                return None
            v = next(vals)
            return {"val_loss": v, "val_ppl": v}

        trainer.evaluate_period = fake_eval
        assert trainer.save_best
        trainer.train()
        return trainer

    got = run(_port_trainer(tmp_path, **kw))
    run(_jax_trainer(tmp_path, **kw))
    kept = ckpt.snapshot_epochs(f"{tmp_path}/port/ckpt", kw["job_id"])
    assert kept == jax_ckpt.snapshot_epochs(f"{tmp_path}/jax/ckpt", kw["job_id"])
    assert kept == sorted({2, *range(10 - 2 * (keep - 1), 11, 2)})
    assert got.best_snapshot_epoch == 2


@functools.cache
def _nan_runs(root: str) -> dict:
    """``nan@step:5`` with ``nan_policy="recover"`` on both packages (roll
    back at the first hit, one grace window of 0.1x); the port's state
    right after the rollback and the snapshot file it came from, and the
    learning rate of each update."""
    kw = dict(steps=8, save_every=2, eval_every=0, log_every=2, nan_policy="recover",
              nan_max_consecutive=1, nan_grace_scale=0.1, nan_grace_periods=1,
              job_id="lm-nan")
    jax_faultinject.activate("nan@step:5")
    jax_t = _jax_trainer(root, **kw)
    jax_t.train()
    faultinject.activate("nan@step:5")
    port = _port_trainer(root, **kw)
    seen = {"lrs": []}
    restore, make_fns = port._rollback_restore, port._make_fns

    def spy_restore(step):
        restore(step)
        seen["state"] = {k: v.clone() for k, v in port.state.model.state_dict().items()}
        seen["file"] = torch.load(
            ckpt.snapshot_path(f"{root}/port/ckpt", "lm-nan", step) / ckpt.STATE_FILE,
            weights_only=True)["state"]["model"]

    def spy_fns():
        # every build of the step is spied: the grace window's entry and
        # exit rebuild it, as the JAX trainer recompiles its step
        fns = make_fns()

        def spy_train(state, inp, tgt):
            seen["lrs"].append((state.step, state.optimizer.learning_rate()))
            return fns.train(state, inp, tgt)

        return fns._replace(train=spy_train)

    port._rollback_restore = spy_restore
    port._make_fns = spy_fns
    port.fns = spy_fns()
    port.train()
    return {"jax": jax_t, "port": port, **seen}


def test_nan_rollback_matches_jax(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lm_nan"))
    r = _nan_runs(root)
    got = [(e["step"], e["period"], e["resumed_at"])
           for e in jax_read_events(events_path(f"{root}/port/logs", "lm-nan"))
           if e["kind"] == "rollback"]
    want = [(e["step"], e["period"], e["resumed_at"])
            for e in jax_read_events(events_path(f"{root}/jax/logs", "lm-nan"))
            if e["kind"] == "rollback"]
    assert got == want and len(got) == 1
    assert r["port"].recovery.rollbacks == r["jax"].recovery.rollbacks == 1
    assert r["port"].state.step == int(r["jax"].state.step) == 8
    assert r["port"].update_scale == r["jax"].update_scale == 1.0
    _assert_rows_close(_rows(root, "port", "loss", job="lm-nan"),
                       _rows(root, "jax", "loss", job="lm-nan"))
    # the rollback restored the step-4 snapshot bit for bit
    assert r["state"].keys() == r["file"].keys()
    for k, v in r["file"].items():
        assert torch.equal(r["state"][k], v), k
    # steps 4-5 again at 0.1x (the grace window (4, 6]), then 1x
    scales = [(s, round(lr / 1e-3, 6)) for s, lr in r["lrs"]]
    assert scales == [(s, 1.0) for s in range(6)] + [(4, 0.1), (5, 0.1), (6, 1.0), (7, 1.0)]


def test_resumed_moe_run_anneals_by_the_jax_rule(tmp_path, capsys):
    """A MoE run annealed at step 4, preempted after step 6 and resumed: the
    resumed trainer starts from the configured capacity and anneals again
    after its first window, as the JAX trainer (which builds its config
    afresh) does; the same losses."""
    moe = dict(TINY, num_experts=4, expert_top_k=2, moe_group=0, capacity_factor=1.5,
               capacity_factor_min=1.0, capacity_anneal_drop=0.0, capacity_anneal_step=4)
    kw = dict(cfg=moe, steps=8, log_every=2, save_every=4, eval_every=0, job_id="lm-moe")
    caps = {}
    for side, make, pkg in (("port", _port_trainer, faultinject),
                            ("jax", _jax_trainer, jax_faultinject)):
        out = _preempt_and_resume(functools.partial(make, tmp_path, **kw), pkg)
        printed = capsys.readouterr().out
        anneals = [line.split("|")[0].split()[1] for line in printed.splitlines()
                   if "capacity anneal" in line]
        caps[side] = (out["resumed"], anneals, out["final"].cfg.capacity_factor)
    assert caps["port"] == caps["jax"] == ((PREEMPT_STEP + 1, 3, 1), ["4", "8"], 1.0)
    _assert_rows_close(_rows(tmp_path, "port", "loss", job="lm-moe"),
                       _rows(tmp_path, "jax", "loss", job="lm-moe"))


def test_profile_dir_writes_a_trace(tmp_path):
    t = _port_trainer(tmp_path, steps=6, eval_every=0, log_every=2, checkpoint_dir=None,
                      log_dir=None, profile_dir=str(tmp_path / "prof"), job_id="lm-prof")
    t.train()
    trace = tmp_path / "prof" / "lm-prof-trace.json"
    assert trace.is_file() and trace.stat().st_size > 0
    assert t.state.step == 6


# ------------------------------------------------------------ load_params

VOCAB = 48  # a non-square head: (48, 32)


def _snapshot_state(vocab: int = VOCAB) -> dict:
    """A tiny model after one step, in the layout of
    ``LMTrainer.snapshot_state``."""
    fns = make_lm_step_fns(LMConfig(**{**TINY, "vocab_size": vocab}), LMMeshSpec(), _adamw,
                           0, 2, 8, device="cpu")
    state = fns.init_state()
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, vocab, (2, 9)))
    fns.train(state, toks[:, :-1], toks[:, 1:])
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "step": state.step}


def _save_raw(root, job, state, **payload_extra) -> None:
    """A snapshot file written by hand: ``format`` omitted (a format-less
    writer) unless given."""
    path = ckpt.snapshot_path(root, job, 0)
    path.mkdir(parents=True)
    torch.save({"state": state, "epoch": 0, **payload_extra}, path / ckpt.STATE_FILE)


def _transposed_head(state: dict) -> dict:
    model = dict(state["model"])
    model[ckpt.HEAD_KERNEL] = model[ckpt.HEAD_KERNEL].t().contiguous()
    return {**state, "model": model}


def _assert_params(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_load_params_restores_the_model_only(tmp_path):
    state = _snapshot_state()
    ckpt.save_snapshot(tmp_path, "modern", 0, state)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = ckpt.load_params(tmp_path, "modern", 0)
    _assert_params(got, state["model"])
    assert got[ckpt.HEAD_KERNEL].shape == (VOCAB, TINY["d_model"])
    with pytest.raises(FileNotFoundError, match="latest for job 'modern': 0"):
        ckpt.load_params(tmp_path, "modern", 3)


def test_load_params_migrates_a_format_less_model_major_head(tmp_path):
    state = _snapshot_state()
    _save_raw(tmp_path, "legacy", _transposed_head(state))
    _assert_params(ckpt.load_params(tmp_path, "legacy", 0, vocab_size=VOCAB), state["model"])
    # format-less but already vocab-major: loaded as saved
    _save_raw(tmp_path, "legacy-vm", state)
    _assert_params(ckpt.load_params(tmp_path, "legacy-vm", 0, vocab_size=VOCAB),
                   state["model"])


def test_load_params_without_vocab_size_warns(tmp_path):
    state = _snapshot_state()
    _save_raw(tmp_path, "legacy", _transposed_head(state))
    with pytest.warns(UserWarning, match="orientation unverified"):
        got = ckpt.load_params(tmp_path, "legacy", 0)
    assert got[ckpt.HEAD_KERNEL].shape == (TINY["d_model"], VOCAB)  # as saved


def test_load_params_square_head_warns(tmp_path):
    state = _snapshot_state(vocab=TINY["d_model"])
    _save_raw(tmp_path, "square", state)
    with pytest.warns(UserWarning, match="SQUARE lm_head"):
        got = ckpt.load_params(tmp_path, "square", 0, vocab_size=TINY["d_model"])
    _assert_params(got, state["model"])
    # the same square head with the format field loads silently
    ckpt.save_snapshot(tmp_path, "square-new", 0, state)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ckpt.load_params(tmp_path, "square-new", 0, vocab_size=TINY["d_model"])


def test_load_params_newer_format_warns(tmp_path):
    state = _snapshot_state()
    _save_raw(tmp_path, "future", state, format=ckpt.SNAPSHOT_FORMAT + 97)
    with pytest.warns(UserWarning, match="newer than"):
        got = ckpt.load_params(tmp_path, "future", 0)
    _assert_params(got, state["model"])


def test_load_params_of_a_trained_run_matches_jax(runs):
    """The params-only restore of the port run's newest snapshot is the
    model part of the whole snapshot, and the JAX run's, restored by the
    JAX ``load_params``, is within ``test_torch_lm_train.PARAM_ATOL`` of
    it."""
    root, _ = runs
    step = ckpt.latest_epoch(f"{root}/port/ckpt", JOB)
    got = ckpt.load_params(f"{root}/port/ckpt", JOB, step, vocab_size=256)
    _assert_params(got, ckpt.load_snapshot(f"{root}/port/ckpt", JOB, step)[0]["model"])
    want = lm_params_from_jax(jax_ckpt.load_params(f"{root}/jax/ckpt", JOB, step))
    assert got.keys() == want.keys()
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    print(f"largest parameter difference at step {step}: {worst:.2e}")
    assert worst <= PARAM_ATOL
