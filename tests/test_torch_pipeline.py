"""The port's pipeline (ddl_tpu_torch/parallel/pipeline.py) against the JAX
package's ``make_pipeline_step_fns`` on the simulated CPU mesh: GPipe and
1F1B, remat, eval, a second data row and four stages, with the packed and
the fused blocks; the global-norm clipping across stages against the
one-device step; and the schedules' clock.

The ranks are real processes over gloo on the CPU, started by the port's
spawner (``launch.spawn_local``): each runs this file as a script
(``_rank_main``, torch only) over every case of its world and saves what
it computed; the JAX side runs in the test process.  Weights, with random
running statistics so their momentum update shows, are carried across by
``models/convert.from_jax_params``.  One SGD step at lr 0.01, as in the JAX
package's tests (one step; Adam's first step is lr * sign(g), which turns
f32 noise on near-zero gradients into full steps): the JAX pipeline itself
differs from the JAX sequential reference by up to 2.4e-6 in a parameter
after it, and a second step carries such noise past 1e-5 in the loss.  The limits are the
JAX package's own tests' (``tests/test_parallel.py``,
``tests/test_pipeline_deep.py``): the loss 1e-5, the predictions equal,
the parameters and running statistics 2e-5 absolute and 1e-4 relative
(1e-4 absolute for four stages), 1F1B and remat against GPipe without
remat 1e-6, the eval logits 1e-5 absolute and 1e-4 relative."""

import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import launch
from ddl_tpu_torch.config import ModelConfig
from ddl_tpu_torch.models import DenseNet
from ddl_tpu_torch.models.densenet import stage_boundary_shapes
from ddl_tpu_torch.ops import normalize_images
from ddl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from ddl_tpu_torch.parallel.pipeline import HANDOFF, make_pipeline_step_fns, schedule_ticks
from ddl_tpu_torch.train import make_train_step
from ddl_tpu_torch.train.state import Optimizer

HERE = Path(__file__).resolve()
# 16 images: with 8, M=4 leaves 2 a microbatch, and the four-stage net's
# last block, at 1x1, normalizes 2 values a channel, which amplifies f32
# rounding so far that the CPU's thread count alone moves the loss by 1.2e-5
IMAGE, BATCH, STEPS, LR, CLASSES = 32, 16, 1, 0.01, 5
# two stages split at the third block (the reference's cut) with the fused
# blocks 1 and 4 on either side of it; four stages as test_pipeline_deep.py
MODELS = {
    "two": dict(growth_rate=4, block_config=(2, 2, 2, 2), num_init_features=8, bn_size=2,
                num_classes=CLASSES, split_blocks=(2,), dense_block_fused_blocks=(0, 3)),
    "four": dict(growth_rate=4, block_config=(1, 1, 1, 1), num_init_features=8, bn_size=2,
                 num_classes=CLASSES, split_blocks=(1, 2, 3)),
}
CLIP = {"learning_rate": 1e-3, "grad_clip_norm": 1e-2}
CLIP_STEPS = 3


def _case(model, impl, schedule, m, remat, clip=False):
    return dict(model=model, impl=impl, schedule=schedule, m=m, remat=remat, clip=clip)


# world (data, pipe) -> {case name: case}
WORLDS = {
    (1, 2): {
        "gpipe_m2": _case("two", "packed", "gpipe", 2, False),
        "gpipe_m4": _case("two", "packed", "gpipe", 4, False),
        "1f1b_m2": _case("two", "packed", "1f1b", 2, False),
        "1f1b_m4": _case("two", "packed", "1f1b", 4, False),
        "gpipe_m2_remat": _case("two", "packed", "gpipe", 2, True),
        "1f1b_m4_remat": _case("two", "packed", "1f1b", 4, True),
        "fused_gpipe_m2_remat": _case("two", "fused", "gpipe", 2, True),
        "fused_1f1b_m2_remat": _case("two", "fused", "1f1b", 2, True),
        "clip": _case("two", "packed", "gpipe", 1, True, clip=True),
    },
    (2, 2): {
        "gpipe_m2": _case("two", "packed", "gpipe", 2, False),
        "1f1b_m2": _case("two", "packed", "1f1b", 2, False),
        "gpipe_m2_remat": _case("two", "packed", "gpipe", 2, True),
        "fused_gpipe_m2_remat": _case("two", "fused", "gpipe", 2, True),
    },
    (1, 4): {
        "gpipe_m2": _case("four", "packed", "gpipe", 2, False),
        "gpipe_m4": _case("four", "packed", "gpipe", 4, False),
        "1f1b_m4": _case("four", "packed", "1f1b", 4, False),
    },
}


def _cfg(case) -> ModelConfig:
    return ModelConfig(**MODELS[case["model"]], dense_block_impl=case["impl"],
                       compute_dtype="float32", remat=case["remat"])


def _rank_main(inputs: str, out: str) -> None:
    """One rank: every case of its world from the saved weights and
    batches (its data row's rows of each): the steps, then the eval."""
    launch.bootstrap("cpu")
    data = torch.load(inputs, weights_only=False)
    mesh = build_mesh(MeshSpec(*data["world"]), "cpu")
    rows = BATCH // mesh.spec.data
    mine = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
    result = {}
    for name, case in data["cases"].items():
        cfg = _cfg(case)
        stage = DenseNet(cfg, stage=mesh.pipe_index)
        weights = data["weights"][(case["model"], case["impl"])]
        stage.load_state_dict({k: weights[k] for k in stage.state_dict()})
        opt = (Optimizer(stage.parameters(), **CLIP) if case["clip"]
               else torch.optim.SGD(stage.parameters(), lr=LR))
        fns = make_pipeline_step_fns(stage, opt, mesh, torch.float32, case["m"],
                                     stage_boundary_shapes(cfg, IMAGE), CLASSES,
                                     remat=case["remat"], schedule=case["schedule"])
        HANDOFF.update(sends=0, recvs=0, bytes=0)
        losses, preds = [], []
        for t in range(data["clip_steps"] if case["clip"] else data["steps"]):
            loss, pred = fns.train(data["images"][t][mine], data["labels"][t][mine])
            losses.append(loss.item())
            preds.append(mesh.gather(pred.numpy()))
        handoff = dict(HANDOFF)
        logits = mesh.gather(fns.evaluate(data["eval"][mine]).numpy())
        result[name] = {"losses": np.asarray(losses), "preds": np.stack(preds),
                        "logits": logits, "state": stage.state_dict(), "handoff": handoff}
    torch.save(result, Path(out) / f"rank{mesh.rank}.pt")


@functools.cache
def _inputs():
    """Seeded batches and the JAX initial weights of each model and impl,
    with random running statistics."""
    import jax

    from ddl_tpu.config import ModelConfig as JaxModelConfig
    from ddl_tpu.models.densenet import build_stages, init_stages
    from ddl_tpu_torch.models import from_jax_params

    rng = np.random.default_rng(11)
    n = max(STEPS, CLIP_STEPS)
    data = {"images": torch.from_numpy(rng.integers(0, 256, (n, BATCH, IMAGE, IMAGE, 3),
                                                    dtype=np.uint8)),
            "labels": torch.from_numpy(rng.integers(0, CLASSES, (n, BATCH)).astype(np.int32)),
            "eval": torch.from_numpy(rng.integers(0, 256, (BATCH, IMAGE, IMAGE, 3),
                                                  dtype=np.uint8)),
            "weights": {}}
    jax_state = {}
    for model in MODELS:
        for impl in ("packed", "fused"):
            cfg = JaxModelConfig(**MODELS[model], dense_block_impl=impl,
                                 compute_dtype="float32", remat=False)
            stages = build_stages(cfg)
            params, stats = jax.device_get(init_stages(stages, jax.random.key(0), IMAGE))
            stats = jax.tree_util.tree_map(
                lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), stats)
            jax_state[(model, impl)] = (params, stats)
            data["weights"][(model, impl)] = from_jax_params(params, stats)
    return data, jax_state


@functools.cache
def _run(world: tuple[int, int], root: str):
    """The ranks' results for one world (rank order)."""
    data, _ = _inputs()
    Path(root).mkdir(parents=True, exist_ok=True)
    inputs = Path(root) / "inputs.pt"
    torch.save(dict(data, world=world, cases=WORLDS[world], steps=STEPS,
                    clip_steps=CLIP_STEPS), inputs)
    n = world[0] * world[1]
    code = launch.spawn_local([sys.executable, str(HERE), str(inputs), root], n,
                              env=dict(os.environ, OMP_NUM_THREADS="1",
                                       PYTHONPATH=str(HERE.parents[1])),
                              log_dir=Path(root) / "logs", timeout_s=600)
    assert code == 0, (Path(root) / "logs" / "rank0.log").read_text()[-3000:]
    return [torch.load(Path(root) / f"rank{r}.pt", weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    return lambda world: _run(world, str(root / f"w{world[0]}x{world[1]}"))


def _port(ranks, world, name) -> dict:
    """A case's result with its state the union of data row 0's stages."""
    got = dict(ranks[0][name])
    got["state"] = {k: v for r in range(world[1]) for k, v in ranks[r][name]["state"].items()}
    return got


@functools.cache
def _jax(world: tuple[int, int], name: str):
    """The case through ``make_pipeline_step_fns`` on a (data, pipe) mesh
    with optax.sgd: losses, predictions, eval logits and the final state
    in the port's names."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl_tpu.config import ModelConfig as JaxModelConfig
    from ddl_tpu.models.densenet import build_stages
    from ddl_tpu.models.densenet import stage_boundary_shapes as jax_boundary_shapes
    from ddl_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ddl_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from ddl_tpu.parallel.pipeline import make_pipeline_step_fns as jax_pipeline
    from ddl_tpu.train.state import TrainState
    from ddl_tpu_torch.models import from_jax_params

    case = WORLDS[world][name]
    data, jax_state = _inputs()
    cfg = JaxModelConfig(**MODELS[case["model"]], dense_block_impl=case["impl"],
                         compute_dtype="float32", remat=case["remat"])
    stages = build_stages(cfg)
    params, stats = jax_state[(case["model"], case["impl"])]
    tx = optax.sgd(LR)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params))
    fns = jax_pipeline(stages, tx, jax_build_mesh(JaxMeshSpec(*world)), jnp.float32,
                       num_microbatches=case["m"],
                       boundary_shapes=jax_boundary_shapes(cfg, IMAGE), num_classes=CLASSES,
                       remat=case["remat"], schedule=case["schedule"])
    losses, preds = [], []
    for t in range(STEPS):
        state, loss, pred = fns.train(state, jnp.asarray(data["images"][t].numpy()),
                                      jnp.asarray(data["labels"][t].numpy()))
        losses.append(float(loss))
        preds.append(np.asarray(pred))
    logits = np.asarray(fns.evaluate(state, jnp.asarray(data["eval"].numpy())))
    return {"losses": np.asarray(losses), "preds": np.stack(preds), "logits": logits,
            "state": from_jax_params(*jax.device_get((state.params, state.batch_stats)))}


def _assert_close(got: dict, want: dict, loss_tol: float, state_atol: float,
                  rtol: float = 1e-4) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], atol=loss_tol, rtol=0)
    np.testing.assert_array_equal(got["preds"], want["preds"])
    assert set(got["state"]) == set(want["state"])
    for k, w in want["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), atol=state_atol,
                                   rtol=rtol, err_msg=k)


# test_pipeline_matches_sequential's (data, M) grid and limits, against
# the JAX pipeline (which that test holds to the sequential math)
@pytest.mark.parametrize("world,name", [((1, 2), "gpipe_m2"), ((1, 2), "gpipe_m4"),
                                        ((2, 2), "gpipe_m2")],
                         ids=["d1-m2", "d1-m4", "d2-m2"])
def test_gpipe_matches_the_jax_pipeline(runs, world, name):
    _assert_close(_port(runs(world), world, name), _jax(world, name), 1e-5, 2e-5)


@pytest.mark.parametrize("world,m", [((1, 2), 2), ((2, 2), 2), ((1, 2), 4)],
                         ids=["d1-m2", "d2-m2", "d1-m4"])
def test_1f1b_matches_gpipe(runs, world, m):
    """test_1f1b_matches_gpipe's grid: the port's 1F1B against its GPipe
    at 1e-6, and against the JAX 1F1B at the sequential limits."""
    ranks = runs(world)
    got = _port(ranks, world, f"1f1b_m{m}")
    _assert_close(got, _port(ranks, world, f"gpipe_m{m}"), 1e-6, 1e-6, rtol=0)
    _assert_close(got, _jax(world, f"1f1b_m{m}"), 1e-5, 2e-5)


@pytest.mark.parametrize("world,name,plain", [((1, 2), "gpipe_m2_remat", "gpipe_m2"),
                                              ((1, 2), "1f1b_m4_remat", "1f1b_m4"),
                                              ((2, 2), "gpipe_m2_remat", "gpipe_m2")],
                         ids=["gpipe-d1", "1f1b-d1", "gpipe-d2"])
def test_pipeline_remat_matches_no_remat(runs, world, name, plain):
    """test_pipeline_remat_matches_no_remat's limit (1e-6) against the same
    schedule without remat, running statistics included: the recompute
    leaves them alone, so they advance exactly once per microbatch; and
    the JAX remat run at the sequential limits."""
    ranks = runs(world)
    got = _port(ranks, world, name)
    _assert_close(got, _port(ranks, world, plain), 1e-6, 1e-6, rtol=0)
    _assert_close(got, _jax(world, name), 1e-5, 2e-5)


@pytest.mark.parametrize("name", list(WORLDS[(2, 2)]))
def test_every_data_row_ends_bit_equal_to_the_first(runs, name):
    """The averages over ``data`` give each row the same sums, so row 1's
    stages end with row 0's parameters and running statistics bit for bit,
    and return its losses, predictions and eval logits: a row whose update
    or average went astray would fail here, where the comparisons above
    read row 0 alone."""
    ranks = runs((2, 2))
    for pipe in range(2):
        got, want = ranks[2 + pipe][name], ranks[pipe][name]
        for key in ("losses", "preds", "logits"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["state"].keys() == want["state"].keys()
        for k, v in want["state"].items():
            assert torch.equal(got["state"][k], v), (pipe, k)


def test_remat_recompute_would_move_the_statistics_again(runs):
    """The check above can see a second update: with it the running
    statistics would have moved by 0.9^(2M) instead of 0.9^M of their
    distance from the batch's, far outside 1e-6.  Here the recompute's
    update, which ``DenseNet.running_stats_frozen`` holds off, is shown to
    be there, and the statistics to move again once the block ends."""
    cfg = ModelConfig(**MODELS["two"], compute_dtype="float32")
    stage = DenseNet(cfg, stage=0).train()
    data, _ = _inputs()
    weights = data["weights"][("two", "packed")]
    stage.load_state_dict({k: weights[k] for k in stage.state_dict()})
    x = normalize_images(data["images"][0][:4], torch.float32)
    key = "features.norm0.running_mean"
    before = stage.state_dict()[key].clone()
    with stage.running_stats_frozen():
        stage(x)
    assert torch.equal(stage.state_dict()[key], before)
    stage(x)
    assert not torch.allclose(stage.state_dict()[key], before, atol=1e-3)


@pytest.mark.parametrize("world,name", [((1, 2), "gpipe_m2"), ((2, 2), "gpipe_m2"),
                                        ((1, 2), "1f1b_m4_remat")],
                         ids=["d1", "d2", "1f1b-remat-d1"])
def test_pipeline_eval_matches_the_jax_eval(runs, world, name):
    """test_pipeline_eval_matches_sequential_eval's limits: the GPipe
    forward in eval mode after the steps, every data row gathered."""
    got = _port(runs(world), world, name)["logits"]
    np.testing.assert_allclose(got, _jax(world, name)["logits"], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("world,name", [((1, 2), "fused_gpipe_m2_remat"),
                                        ((1, 2), "fused_1f1b_m2_remat"),
                                        ((2, 2), "fused_gpipe_m2_remat")],
                         ids=["gpipe-d1", "1f1b-d1", "gpipe-d2"])
def test_fused_blocks_pipeline_matches_the_jax_pipeline(runs, world, name):
    """The fused blocks 1 and 4 (stage 0 and stage 1) through the kernels'
    plain versions, with remat: the JAX pipeline's fused blocks (Pallas in
    interpret mode) at the sequential limits."""
    got, want = _port(runs(world), world, name), _jax(world, name)
    _assert_close(got, want, 1e-5, 2e-5)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["gpipe_m2", "gpipe_m4", "1f1b_m4"])
def test_four_stage_pipeline_matches_the_jax_pipeline(runs, name):
    """test_pipeline_deep.py's four stages (M=4 exercises 1F1B's warmup,
    steady and cooldown phases): its limit, 1e-4, for the state."""
    world = (1, 4)
    got = _port(runs(world), world, name)
    _assert_close(got, _jax(world, name), 1e-5, 1e-4)
    if name != "gpipe_m4":
        _assert_close(got, _port(runs(world), world, name.replace("1f1b", "gpipe")),
                      1e-6, 1e-6, rtol=0)


def test_clip_norm_spans_the_stages(runs):
    """Adam with global-norm clipping that binds (norm far above 1e-2) and
    one microbatch: the pipeline's update equals the one-device step's
    on the same batches, which takes the norm over the whole model;
    clipping each stage by its own norm would not (test_dp_matches_single's
    limits)."""
    world = (1, 2)
    got = _port(runs(world), world, "clip")
    data, _ = _inputs()
    model = DenseNet(_cfg(WORLDS[world]["clip"]), num_stages=1)
    model.load_state_dict(data["weights"][("two", "packed")])
    step = make_train_step(model.train(), Optimizer(model.parameters(), **CLIP), torch.float32,
                           normalize_images)
    losses = [step(data["images"][t], data["labels"][t])[0].item() for t in range(CLIP_STEPS)]
    np.testing.assert_allclose(got["losses"], losses, atol=1e-5, rtol=0)
    for k, w in model.state_dict().items():
        np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("world", [(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
def test_handoff_moves_each_microbatch_once_each_way(runs, world):
    """Every stage but the last sends each microbatch's activation once a
    step and every stage but the first its cotangent; gloo on the CPU."""
    ranks = runs(world)
    name = "gpipe_m2"
    for r, rank in enumerate(ranks):
        s = r % world[1]
        h = rank[name]["handoff"]
        sends = STEPS * 2 * ((s < world[1] - 1) + (s > 0))
        assert (h["transport"], h["sends"], h["recvs"]) == ("gloo, on the CPU", sends, sends)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("stages", [2, 3, 4])
def test_schedule_clock(schedule, stages):
    """Each stage runs every forward and backward once, a backward after
    its forward and after the next stage's, the forward after the previous
    stage's; 1F1B holds at most min(2(P-1-s)+1, M) stage inputs."""
    for m in range(1, 7):
        ticks, at = schedule_ticks(schedule, stages, m)
        done = {}
        for s in range(stages):
            for t in range(ticks):
                for kind, mb in zip("FB", at(s, t)):
                    if mb is not None:
                        assert (kind, mb, s) not in done
                        done[(kind, mb, s)] = t
        assert len(done) == 2 * stages * m
        for (kind, mb, s), t in done.items():
            if kind == "F":
                assert s == 0 or done[("F", mb, s - 1)] < t
            else:
                assert done[("F", mb, s)] <= t
                assert s == stages - 1 or done[("B", mb, s + 1)] < t
        if schedule == "1f1b":
            for s in range(stages):
                live = [sum(done[("F", mb, s)] <= t < done[("B", mb, s)] or
                            done[("F", mb, s)] == t for mb in range(m)) for t in range(ticks)]
                assert max(live) <= min(2 * (stages - 1 - s) + 1, m)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
