"""ZeRO-1 for the port's data-parallel DenseNet (``ddl_tpu_torch/train/
fused_optim.py``, ``parallel/rules.py``, ``train/state.Optimizer``) against
the JAX package's ``with_zero`` (``tests/test_zero_sharding.py``'s CNN
cases) and against the port's own replicated step.

The ranks are real processes over gloo on the CPU, started by the port's
spawner; each runs this file as a script (``_rank_main``, torch only) and
saves what it computed.  Three worlds run one after the other: two ranks
(the trajectories, the grace scale, the Trainer's snapshots), four ranks
(resuming the two-rank snapshot and writing its own) and two ranks again
(resuming the four-rank one, and the ZeRO <-> replicated resumes).  The
JAX side runs in the test process on ``tests/conftest.py``'s host
devices.  Tolerances are stated where they are used."""

import functools
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch import launch
from ddl_tpu_torch.config import ModelConfig, preset
from ddl_tpu_torch.models import DenseNet
from ddl_tpu_torch.models.convert import _flatten, _torch_key
from ddl_tpu_torch.ops import normalize_images
from ddl_tpu_torch.parallel import rules
from ddl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from ddl_tpu_torch.train import make_train_step
from ddl_tpu_torch.train.fused_optim import with_zero
from ddl_tpu_torch.train.state import Optimizer

HERE = Path(__file__).resolve()
# tests/test_zero_sharding.py's CNN: every leaf of 64 elements or more is
# eligible at its threshold of 64
TINY = dict(growth_rate=4, block_config=(2, 2), num_init_features=8, bn_size=2,
            num_classes=5, split_blocks=(1,))
IMAGE, BATCH, STEPS, LR, THRESHOLD = 16, 8, 4, 1e-3, 64
# the Trainer's model: each layer's 3x3 conv (3 * 3 * 128 * 32 = 36864) and
# block 2's second 1x1 (128 * 72 = 9216) are over the real threshold of
# 8192, the rest under it
TRAINER = ["model.growth_rate=32", "model.block_config=[2,2]", "model.num_init_features=16",
           "model.bn_size=4", "model.remat=false", "data.image_size=16", "data.num_workers=0",
           "data.dataset_dir=", "data.synthetic_num_train=32", "data.synthetic_num_test=16",
           "data.global_batch_size=8", "data.eval_batch_size=8", "train.max_epochs=1",
           "train.save_best_qwk=false", "train.async_checkpoint=false"]


def _trainer_cfg(data: int, zero: bool, root: str, job: str, **extra):
    overrides = dict(o.split("=", 1) for o in TRAINER)
    overrides.update({"mesh.data": str(data), "train.zero_sharding": str(zero).lower(),
                      "train.checkpoint_dir": f"{root}/ckpt", "train.log_dir": f"{root}/logs",
                      **extra})
    return preset("dp", **overrides)


# ---------------------------------------------------------------- the ranks


def _trajectories(mesh, data) -> dict:
    """The replicated and the ZeRO step (threshold 64), 4 Adam steps at
    1e-3 from the JAX weights, at update scale 1 and 0.1 (the grace
    window): losses, state and the optimizer's state (gathered)."""
    b = BATCH // mesh.size
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    out = {}
    for zero in (False, True):
        for scale in (1.0, 0.1):
            model = DenseNet(ModelConfig(**TINY, compute_dtype="float32"), num_stages=1)
            model.load_state_dict(data["weights"])
            opt = Optimizer(model.parameters(), LR, fused=True)
            if zero:
                opt = with_zero(opt, mesh, threshold=THRESHOLD)
            opt.update_scale = scale
            step = make_train_step(model.train(), opt, torch.float32, normalize_images,
                                   mesh=mesh)
            losses = [step(data["images"][t][rows], data["labels"][t][rows])[0].item()
                      for t in range(STEPS)]
            out[(zero, scale)] = {
                "losses": mesh.gather(np.asarray(losses)).reshape(mesh.size, STEPS).mean(0),
                "state": model.state_dict(), "optimizer": opt.state_dict(),
                "opt_bytes": opt.state_bytes(),
                "sharded": None if opt.zero is None else len(opt.zero.leaves)}
    return out


def _trainer(data: int, zero: bool, root: str, job: str, mesh, **extra):
    """The ``dp`` Trainer of ``TRAINER`` on this world; it resumes by itself
    from its job's newest snapshot."""
    from ddl_tpu_torch.train import Trainer

    os.environ["DDL_JOB_ID"] = job
    return Trainer(_trainer_cfg(data, zero, root, job, **extra), device="cpu", mesh=mesh)


def _train_and_save(t) -> None:
    """Train to ``max_epochs`` and write the last epoch's snapshot (every
    rank takes part: a ZeRO state is gathered; rank 0 writes)."""
    t.train()
    t.data_cursor = {"period": t.epochs_run, "offset": 0}
    t.save_snapshot(t.epochs_run - 1)


def _rank_main(phase: str, root: str) -> None:
    launch.bootstrap("cpu")
    world = int(os.environ["DDL_NUM_PROCESSES"])
    mesh = build_mesh(MeshSpec(world, 1), "cpu")
    result = {}
    if phase == "w2a":
        result["traj"] = _trajectories(mesh, torch.load(f"{root}/inputs.pt", weights_only=True))
        # the ZeRO and the replicated Trainer, one epoch each, each writing
        # its epoch-0 snapshot
        for job, zero in (("zero", True), ("rep", False)):
            t = _trainer(2, zero, root, job, mesh)
            _train_and_save(t)
            result[job] = {"opt_bytes": t.optimizer.state_bytes(),
                           "sharded": None if t.optimizer.zero is None
                           else len(t.optimizer.zero.leaves)}
    elif phase == "w4":
        # the two-rank ZeRO snapshot into four ranks of ZeRO, then one epoch
        t = _trainer(4, True, root, "zero", mesh, **{"train.max_epochs": "2"})
        # a copy: the state's tensors are the live ones, which train on
        result["loaded"] = ckpt.map_tensors(t.snapshot_state(), lambda _, x: x.clone())
        _train_and_save(t)
    elif phase == "w2b":
        # the four-rank snapshot back into two ZeRO ranks and into two
        # replicated ones; the replicated snapshot into ZeRO
        for name, zero, job in (("zero", True, "zero"), ("rep", False, "zero"),
                                ("rep_into_zero", True, "rep")):
            t = _trainer(2, zero, root, job, mesh,
                         **({"train.max_epochs": "2"} if job == "zero" else {}))
            result[name] = t.snapshot_state()
    if mesh.rank == 0:
        torch.save(result, f"{root}/{phase}.pt")
    mesh.barrier()


# ---------------------------------------------------------------- the test side


@functools.cache
def _inputs():
    """Seeded batches and the JAX initial weights of ``TINY``."""
    import jax

    from ddl_tpu.config import ModelConfig as JaxModelConfig
    from ddl_tpu.models.densenet import build_stages, init_stages
    from ddl_tpu_torch.models import from_jax_params

    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (STEPS, BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)
    labels = rng.integers(0, 5, (STEPS, BATCH)).astype(np.int32)
    cfg = JaxModelConfig(**TINY, compute_dtype="float32", remat=False)
    stages = build_stages(cfg, num_stages=1)
    params, stats = jax.device_get(init_stages(stages, jax.random.key(0), IMAGE))
    data = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels),
            "weights": from_jax_params(params, stats)}
    return data, (stages, params, stats)


@functools.cache
def _worlds(root: str) -> dict:
    data, _ = _inputs()
    torch.save(data, f"{root}/inputs.pt")
    out = {}
    for phase, world in (("w2a", 2), ("w4", 4), ("w2b", 2)):
        code = launch.spawn_local([sys.executable, str(HERE), phase, root], world,
                                  env=dict(os.environ, OMP_NUM_THREADS="1",
                                           PYTHONPATH=str(HERE.parents[1])),
                                  log_dir=Path(root) / f"logs-{phase}", timeout_s=600)
        assert code == 0, (Path(root) / f"logs-{phase}" / "rank0.log").read_text()[-3000:]
        out[phase] = torch.load(f"{root}/{phase}.pt", weights_only=False)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zero"))
    return root, _worlds(root)


@functools.cache
def _jax_run(zero: bool, scale: float):
    """tests/test_zero_sharding.py's ``_cnn_run`` at data 2 from the same
    weights and batches: fused Adam(1e-3), ``with_zero(threshold=64)``,
    ``scale_tx``; the losses, the final state in the port's names, the
    moments and the JAX trainer's ``opt_state_hbm_bytes``."""
    import jax
    import jax.numpy as jnp

    from ddl_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ddl_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from ddl_tpu.train.fused_optim import fused_adam
    from ddl_tpu.train.fused_optim import with_zero as jax_with_zero
    from ddl_tpu.train.loop import BaseTrainer
    from ddl_tpu.train.recovery import scale_tx
    from ddl_tpu.train.state import create_train_state
    from ddl_tpu.train.steps import make_dp_step_fns
    from ddl_tpu_torch.models import from_jax_params

    data, (stages, params, stats) = _inputs()
    mesh = jax_build_mesh(JaxMeshSpec(data=2))
    tx = fused_adam(LR)
    if zero:
        tx = jax_with_zero(tx, mesh, threshold=THRESHOLD)
    tx = scale_tx(tx, scale)
    state = create_train_state(stages, tx, jax.random.key(0), IMAGE,
                               mesh=mesh if zero else None)
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, stats))
    state = state.replace(opt_state=tx.init(state.params))
    fns = make_dp_step_fns(stages, tx, mesh, jnp.float32)
    losses = []
    for t in range(STEPS):
        state, loss, _ = fns.train(state, jnp.asarray(data["images"][t].numpy()),
                                   jnp.asarray(data["labels"][t].numpy()))
        losses.append(float(loss))

    class T(BaseTrainer):
        def __init__(self, state):
            self.state = state

    adam = state.opt_state[0]
    count_bytes = int(np.asarray(adam.count).nbytes)
    return {"losses": np.asarray(losses),
            "state": from_jax_params(*jax.device_get((state.params, state.batch_stats))),
            "opt_hbm_bytes": T(state).opt_state_hbm_bytes(), "count_bytes": count_bytes}


def _jax_shapes_and_keys(cfg_kw: dict):
    """The JAX DenseNet's parameter leaves (eval_shape, no compute) with
    each one's key in the port, through ``models/convert``'s mapping."""
    import jax

    from ddl_tpu.config import ModelConfig as JaxModelConfig
    from ddl_tpu.models.densenet import build_stages, init_stages

    stages = build_stages(JaxModelConfig(**cfg_kw), num_stages=1)
    params, _ = jax.eval_shape(lambda: init_stages(stages, jax.random.key(0), 224))
    return params, [(path, tuple(leaf.shape), _torch_key(path))
                    for tree in params for path, leaf in _flatten(tree)]


@pytest.mark.parametrize("dp", [2, 3, 4, 8])
def test_eligibility_matches_jax_leaf_by_leaf(dp):
    """DenseNet121: each parameter leaf is ZeRO-eligible in the port exactly
    when ``ddl_tpu.parallel.rules.zero_shard_spec`` shards it (torch's
    layout permutes JAX's dimensions, so the split dimension may differ);
    and ``optimizer_hbm_bytes`` equals the JAX estimate over the rule
    table."""
    from jax.sharding import PartitionSpec as P

    from ddl_tpu.parallel import rules as jax_rules

    model = DenseNet(ModelConfig(), num_stages=1)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    params, leaves = _jax_shapes_and_keys({})
    mesh = types.SimpleNamespace(shape={"data": dp})
    assert sorted(k for _, _, k in leaves) == sorted(shapes)
    for path, shape, key in leaves:
        want = jax_rules.zero_shard_spec(P(), shape, mesh) is not None
        got = rules.zero_shard_spec(shapes[key], dp)
        assert (got is not None) == want, (path, shape, shapes[key])
        if got is not None:
            assert shapes[key][got] % dp == 0
    got = rules.optimizer_hbm_bytes(shapes.values(), dp)
    want = jax_rules.optimizer_hbm_bytes(jax_rules.cnn_rules(), params, mesh)
    assert got == want


def test_densenet121_optimizer_bytes():
    """The saving on DenseNet121: 364 leaves of 6,958,981 parameters, 120
    of them (6,870,208 parameters) eligible at dp 2 and 4; Adam's f32
    moments 55,671,848 bytes a rank replicated, 28,191,016 at dp 2 and
    14,450,600 at dp 4."""
    shapes = [tuple(p.shape) for p in DenseNet(ModelConfig(), num_stages=1).parameters()]
    assert len(shapes) == 364 and sum(int(np.prod(s)) for s in shapes) == 6_958_981
    for dp, zero_bytes in ((2, 28_191_016), (4, 14_450_600)):
        est = rules.optimizer_hbm_bytes(shapes, dp)
        assert est["zero_sharded_leaves"] == 120
        assert sum(int(np.prod(s)) for s in shapes
                   if rules.zero_shard_spec(s, dp) is not None) == 6_870_208
        assert (est["replicated_bytes"], est["zero_bytes"]) == (55_671_848, zero_bytes)


def test_zero_shard_spec_edges():
    assert rules.zero_shard_spec((8191,), 2) is None  # under the threshold
    assert rules.zero_shard_spec((3, 8192), 1) is None  # trivial axis
    assert rules.zero_shard_spec((8193,), 2) is None  # no dimension divides
    assert rules.zero_shard_spec((5, 3, 4096), 2) == 2
    assert rules.zero_shard_spec((64, 2), 4, threshold=64) == 0


@pytest.mark.parametrize("scale", [1.0, 0.1], ids=["scale1", "grace0.1"])
def test_zero_trajectory_bit_equal_to_replicated(worlds, scale):
    """At two ranks each element's sum over the ranks is one addition, so
    the reduce-scatter and the replicated all-reduce agree bit for bit,
    and the sharded update is Adam's math on the same values: losses,
    parameters, running statistics and the gathered moments bit-equal,
    in a grace window's reduced scale too (test_zero_sharding.py:88, :108,
    which hold JAX's to 1e-6 and 1e-5)."""
    _, w = worlds
    traj = w["w2a"]["traj"]
    rep, zero = traj[(False, scale)], traj[(True, scale)]
    assert zero["sharded"] and rep["sharded"] is None
    assert np.array_equal(rep["losses"], zero["losses"])
    for k, v in rep["state"].items():
        assert torch.equal(zero["state"][k], v), k
    assert rep["optimizer"]["count"] == zero["optimizer"]["count"] == STEPS
    got, want = zero["optimizer"]["inner"]["state"], rep["optimizer"]["inner"]["state"]
    assert got.keys() == want.keys()
    for i, per_param in want.items():
        for k, v in per_param.items():
            assert torch.equal(got[i][k], v), (i, k)


@pytest.mark.parametrize("scale", [1.0, 0.1], ids=["scale1", "grace0.1"])
def test_zero_trajectory_matches_jax_zero_step(worlds, scale):
    """Against the JAX CNN ZeRO step at data 2 from the same weights and
    batches: each step's loss within 1e-4 relative (test_torch_dp_trainer's
    limit for Adam runs of both packages), and each parameter within 2.01
    lr a step: Adam moves an element by at most ~lr a step, so where XLA's
    and torch's f32 convolutions give a near-zero gradient opposite signs
    the runs part by up to twice that, and nowhere more.  The running
    statistics follow those parameters, so they are held to what ZeRO may
    not change: every leaf's distance from the JAX ZeRO run equals the
    replicated runs' distance from each other, exactly (each package's
    ZeRO run is bit-equal to its replicated one)."""
    _, w = worlds
    traj = w["w2a"]["traj"]
    zero, rep = traj[(True, scale)], traj[(False, scale)]
    want, want_rep = _jax_run(True, scale), _jax_run(False, scale)
    np.testing.assert_allclose(zero["losses"], want["losses"], rtol=1e-4)
    params = dict(DenseNet(ModelConfig(**TINY), num_stages=1).named_parameters())
    bound = 2.01 * LR * scale * STEPS
    for k, v in want["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        err = (zero["state"][k] - v).abs()
        assert torch.equal(err, (rep["state"][k] - want_rep["state"][k]).abs()), k
        if k in params:
            assert err.max().item() <= bound, (k, err.max().item(), bound)


def test_opt_bytes_equal_jax_trainer_at_data2(worlds):
    """Each rank's optimizer bytes equal the JAX trainer's
    ``opt_state_hbm_bytes`` at data 2 (test_zero_sharding.py:442) less its
    on-device int32 update count, which the port keeps on the host; the
    replicated run's too, and ZeRO's below it."""
    _, w = worlds
    traj = w["w2a"]["traj"]
    for zero in (False, True):
        want = _jax_run(zero, 1.0)
        assert traj[(zero, 1.0)]["opt_bytes"] == want["opt_hbm_bytes"] - want["count_bytes"]
    assert traj[(True, 1.0)]["opt_bytes"] < traj[(False, 1.0)]["opt_bytes"]


def _flat(state, prefix=""):
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, state


def _assert_bit_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    tensors = {k: v for k, v in want.items() if isinstance(v, torch.Tensor)}
    assert tensors and {k for k in got if k in tensors} == tensors.keys()
    for k, v in tensors.items():
        assert torch.equal(got[k], v), k
    assert got["/optimizer/count"] == want["/optimizer/count"]


def _file(root, job, epoch):
    return ckpt.load_snapshot(f"{root}/ckpt", job, epoch)[0]


def test_trainer_zero_saves_the_replicated_layout(worlds):
    """The Trainer under ``train.zero_sharding`` shards the 5 leaves over
    the threshold of 8192 and writes its snapshot in the replicated layout:
    the same keys and shapes as the replicated run's."""
    root, w = worlds
    assert w["w2a"]["zero"]["sharded"] == 5 and w["w2a"]["rep"]["sharded"] is None
    assert w["w2a"]["zero"]["opt_bytes"] < w["w2a"]["rep"]["opt_bytes"]
    z, r = dict(_flat(_file(root, "zero", 0))), dict(_flat(_file(root, "rep", 0)))
    assert z.keys() == r.keys()
    for k, v in r.items():
        if isinstance(v, torch.Tensor):
            assert z[k].shape == v.shape, k


def test_snapshot_round_trip_dp2_dp4_dp2_bit_equal(worlds):
    """test_zero_sharding.py:246's property: a dp 2 ZeRO snapshot resumes
    at dp 4 (the state each rank gathers right after the load equals the
    file bit for bit), the dp 4 run's snapshot resumes at dp 2 again, bit
    for bit (the elastic pod's scale-down moves between such worlds)."""
    root, w = worlds
    _assert_bit_equal(w["w4"]["loaded"], _file(root, "zero", 0))
    _assert_bit_equal(w["w2b"]["zero"], _file(root, "zero", 1))


def test_zero_and_replicated_resume_each_other_bit_equal(worlds):
    """A ZeRO snapshot resumes a replicated run and a replicated snapshot a
    ZeRO run, each bit for bit."""
    root, w = worlds
    _assert_bit_equal(w["w2b"]["rep"], _file(root, "zero", 1))
    _assert_bit_equal(w["w2b"]["rep_into_zero"], _file(root, "rep", 0))


def test_with_zero_is_a_noop_at_data1_and_refuses_non_adam():
    """``with_zero`` returns the optimizer itself on a trivial data axis
    (``--preset single --set train.zero_sharding=true`` runs replicated),
    whatever it is; at data 2 anything but plain Adam is JAX's error."""
    from ddl_tpu_torch.parallel.sharding import LMMeshSpec

    model = DenseNet(ModelConfig(**TINY), num_stages=1)
    for opt in (Optimizer(model.parameters(), LR, fused=True),
                Optimizer(model.parameters(), LR, weight_decay=0.1)):
        assert with_zero(opt, LMMeshSpec()) is opt
    mesh2 = types.SimpleNamespace(spec=MeshSpec(2, 1))
    for kw in (dict(fused=False), dict(fused=True, weight_decay=0.1),
               dict(fused=True, grad_clip_norm=1.0)):
        with pytest.raises(ValueError, match="requires the fused Adam"):
            with_zero(Optimizer(model.parameters(), LR, **kw), mesh2)


def test_single_preset_with_zero_trains_replicated(tmp_path):
    """``--preset single`` with ``train.zero_sharding=true`` is the
    replicated run: the Trainer keeps a replicated optimizer and ends
    bit-equal to the run without it."""
    from ddl_tpu_torch.train import Trainer

    states = []
    for zero in (False, True):
        overrides = dict(o.split("=", 1) for o in TRAINER)
        overrides.update({"train.zero_sharding": str(zero).lower(),
                          "train.checkpoint_dir": str(tmp_path / f"ck{zero}"),
                          "train.log_dir": str(tmp_path / f"logs{zero}"),
                          "data.global_batch_size": "8"})
        t = Trainer(preset("single", **overrides), device="cpu")
        assert t.optimizer.zero is None
        t.train()
        states.append(t.snapshot_state())
    _assert_bit_equal(states[1], states[0])


def test_validation_errors_are_jax_s():
    """test_zero_sharding.py:374/:401: the pipelines refuse
    ``zero_sharding``, and it requires plain fused Adam, with the JAX
    package's messages."""
    from ddl_tpu.config import preset as jax_preset

    for name, extra, match in (("dp_pp", {}, "zero_sharding"), ("pp", {}, "zero_sharding"),
                               ("dp", {"train.fused_adam": False}, "fused_adam"),
                               ("dp", {"train.weight_decay": 0.05}, "weight_decay"),
                               ("dp", {"train.grad_clip_norm": 1.0}, "grad_clip_norm")):
        msgs = []
        for make in (preset, jax_preset):
            with pytest.raises(ValueError, match=match) as err:
                make(name, **{"train.zero_sharding": True, **extra})
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    assert preset("dp", **{"train.zero_sharding": True}).train.zero_sharding is True


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
