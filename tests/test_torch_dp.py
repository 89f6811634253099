"""The port's data-parallel train step (ddl_tpu_torch/train/steps.py under a
parallel.mesh.Mesh of several ranks) against the JAX package's
``make_dp_step_fns`` on a ``(data, 1)`` mesh and against the port's own
one-device step on the same global batch; and the global BatchNorm
statistics (``models/densenet._batch_stats``) with their gradient.

The ranks are real processes over gloo on the CPU, started by the port's
spawner (``launch.spawn_local``): each runs this file as a script
(``_rank_main``, torch only) and saves what it computed; the JAX side and
the one-process references run in the test process.  Weights are carried
across by ``models/convert.from_jax_params``.  SGD updates, as in the JAX
package's ``test_dp_matches_single``: Adam's first step is lr * sign(g),
which turns f32 noise on near-zero gradients into full steps.  At lr 0.01,
not that test's 0.1 for one step: over three steps at 0.1 the tiny net
amplifies f32 noise past the limits even between the JAX package's own
(1, 1) and (2, 1) meshes; at 0.01 every comparison here, that one too,
stays below a tenth of them."""

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
from ddl_tpu_torch.models.densenet import _batch_stats
from ddl_tpu_torch.ops import normalize_images
from ddl_tpu_torch.parallel.mesh import COLLECTIVES, MeshSpec, build_mesh
from ddl_tpu_torch.train import make_train_step

TINY = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16,
            bn_size=2, num_classes=5, dense_block_fused_blocks=(0, 3))
IMPLS = ("packed", "fused")
IMAGE, BATCH, STEPS, LR = 32, 8, 3, 0.01
STATS_SHAPE = (8, 6, 5, 5)  # (global batch, channels, H, W) for the _batch_stats case
HERE = Path(__file__).resolve()


def _model(impl: str) -> DenseNet:
    return DenseNet(ModelConfig(**TINY, dense_block_impl=impl, compute_dtype="float32"),
                    num_stages=1)


def _stats_objective(mu, var, w):
    return (mu * w[0]).sum() + (var * w[1]).sum()


def _rank_main(inputs: str, out: str) -> None:
    """One rank: the DP steps of every impl from the saved weights and
    global batches (this rank's rows of each), then ``_batch_stats`` of
    its share of a batch and the gradient of the objective through it."""
    launch.bootstrap("cpu")
    mesh = build_mesh(MeshSpec(int(os.environ["DDL_NUM_PROCESSES"]), 1), "cpu")
    data = torch.load(inputs, weights_only=True)
    b = BATCH // mesh.size
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    result = {}
    for impl in IMPLS:
        model = _model(impl)
        model.load_state_dict(data[f"weights_{impl}"])
        COLLECTIVES["all_reduces"] = 0
        step = make_train_step(model.train(), torch.optim.SGD(model.parameters(), lr=LR),
                               torch.float32, normalize_images, mesh=mesh)
        losses, preds = [], []
        for t in range(STEPS):
            loss, pred = step(data["images"][t][rows], data["labels"][t][rows])
            losses.append(loss.item())
            preds.append(mesh.gather(pred.numpy()))
        result[impl] = {"losses": mesh.gather(np.asarray(losses)).reshape(mesh.size, STEPS),
                        "preds": np.stack(preds), "state": model.state_dict(),
                        "all_reduces": COLLECTIVES["all_reduces"]}
    x = data["stats_x"][mesh.rank * STATS_SHAPE[0] // mesh.size:
                        (mesh.rank + 1) * STATS_SHAPE[0] // mesh.size].clone().requires_grad_()
    mu, var = _batch_stats(x, (0, 2, 3), mesh.group)
    # each rank's loss is 1/world of the objective, so the ranks' losses
    # sum to it and x's gradient is the objective's
    (_stats_objective(mu, var, data["stats_w"]) / mesh.size).backward()
    result["stats"] = {"mu": mu.detach(), "var": var.detach(), "grad": x.grad}
    torch.save(result, Path(out) / f"rank{mesh.rank}.pt")


@functools.cache
def _inputs():
    """Seeded batches, the JAX initial weights of each impl (random
    running statistics so the momentum update shows), and the stats case."""
    import jax

    from ddl_tpu.config import ModelConfig as JaxModelConfig
    from ddl_tpu.models.densenet import build_stages, init_stages
    from ddl_tpu_torch.models import from_jax_params

    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (STEPS, BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)
    labels = rng.integers(0, 5, (STEPS, BATCH)).astype(np.int32)
    jax_state = {}
    data = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels),
            "stats_x": torch.from_numpy(rng.standard_normal(STATS_SHAPE).astype(np.float32)
                                        * 2 + 0.5),
            "stats_w": torch.from_numpy(rng.standard_normal((2, STATS_SHAPE[1]))
                                        .astype(np.float32))}
    for impl in IMPLS:
        cfg = JaxModelConfig(**TINY, dense_block_impl=impl, compute_dtype="float32",
                             remat=False)
        stages = build_stages(cfg, num_stages=1)
        params, stats = jax.device_get(init_stages(stages, jax.random.key(0), IMAGE))
        stats = jax.tree_util.tree_map(
            lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), stats)
        jax_state[impl] = (stages, params, stats)
        data[f"weights_{impl}"] = from_jax_params(params, stats)
    return data, jax_state


@functools.cache
def _run(world: int, root: str):
    """The ranks' results for a world of ``world`` and the inputs."""
    data, jax_state = _inputs()
    inputs = Path(root) / "inputs.pt"
    torch.save(data, inputs)
    code = launch.spawn_local([sys.executable, str(HERE), str(inputs), root], world,
                              env=dict(os.environ, OMP_NUM_THREADS="1",
                                       PYTHONPATH=str(HERE.parents[1])),
                              log_dir=Path(root) / "logs", timeout_s=300)
    assert code == 0, (Path(root) / "logs" / "rank0.log").read_text()[-3000:]
    ranks = [torch.load(Path(root) / f"rank{r}.pt", weights_only=False) for r in range(world)]
    return data, jax_state, ranks


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world_run(request, tmp_path_factory):
    return request.param, _run(request.param, str(tmp_path_factory.mktemp(f"dp{request.param}")))


@functools.cache
def _jax_steps(world: int, impl: str):
    """``make_dp_step_fns`` on a (world, 1) mesh with optax.sgd: the losses,
    predictions and final parameters and statistics (in the port's names)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ddl_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from ddl_tpu.train.state import create_train_state
    from ddl_tpu.train.steps import make_dp_step_fns
    from ddl_tpu_torch.models import from_jax_params

    data, jax_state = _inputs()
    stages, params, stats = jax_state[impl]
    tx = optax.sgd(LR)
    state = create_train_state(stages, tx, jax.random.key(0), IMAGE)
    state = state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
    fns = make_dp_step_fns(stages, tx, jax_build_mesh(JaxMeshSpec(world, 1)), jnp.float32)
    losses, preds = [], []
    for t in range(STEPS):
        state, loss, pred = fns.train(state, jnp.asarray(data["images"][t].numpy()),
                                      jnp.asarray(data["labels"][t].numpy()))
        losses.append(float(loss))
        preds.append(np.asarray(pred))
    return losses, np.stack(preds), from_jax_params(*jax.device_get(
        (state.params, state.batch_stats)))


def _port_single(data, impl: str):
    """The port's one-device step on the whole global batch."""
    model = _model(impl)
    model.load_state_dict(data[f"weights_{impl}"])
    step = make_train_step(model.train(), torch.optim.SGD(model.parameters(), lr=LR),
                           torch.float32, normalize_images)
    losses, preds = [], []
    for t in range(STEPS):
        loss, pred = step(data["images"][t], data["labels"][t])
        losses.append(loss.item())
        preds.append(pred.numpy())
    return losses, np.stack(preds), model.state_dict()


def _global_losses(rank) -> np.ndarray:
    """Each step's global mean loss: the mean of the ranks' local means
    (equal per-rank batches)."""
    return rank["losses"].mean(0)


def _assert_state_close(got: dict, want: dict) -> None:
    """``test_dp_matches_single``'s limits: 1e-5 absolute and 1e-4
    relative, every parameter and running statistic."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


# test_dp_matches_single's tolerances (ROADMAP §3: f32, where the DP and the
# one-device programs are the same math): loss 1e-5, predictions equal,
# parameters and running statistics 1e-5 abs / 1e-4 rel.
@pytest.mark.parametrize("impl", IMPLS)
def test_dp_step_matches_jax_dp_step(world_run, impl):
    world, (_, _, ranks) = world_run
    want_losses, want_preds, want_state = _jax_steps(world, impl)
    got = ranks[0][impl]
    np.testing.assert_allclose(_global_losses(got), want_losses, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["preds"], want_preds)
    _assert_state_close(got["state"], want_state)


@pytest.mark.parametrize("impl", IMPLS)
def test_dp_step_matches_the_one_device_step(world_run, impl):
    """The same tolerances against the port's own one-device step on the
    global batch; and every rank ends bit-equal to rank 0 (the running
    statistics too, which is why no buffer is synchronised after the
    first broadcast)."""
    world, (data, _, ranks) = world_run
    want_losses, want_preds, want_state = _port_single(data, impl)
    got = ranks[0][impl]
    np.testing.assert_allclose(_global_losses(got), want_losses, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["preds"], want_preds)
    _assert_state_close(got["state"], want_state)
    for other in ranks[1:]:
        for k, v in got["state"].items():
            assert torch.equal(other[impl]["state"][k], v), k


def test_batch_norms_sync_once_each_way(world_run):
    """One all-reduce per train-mode BatchNorm forward and one in its
    backward, packed and fused blocks alike (a fused block's stats pass
    takes the statistics of the input and of each layer's bottleneck and
    new strip but the last's, 2 L for L layers): the tiny model has
    1 + 4 * 2 * 2 + 3 + 1 = 21 BatchNorms."""
    _, (_, _, ranks) = world_run
    norms = 1 + 4 * 2 * 2 + 3 + 1
    for impl in IMPLS:
        assert ranks[0][impl]["all_reduces"] == 2 * norms * STEPS, impl


@pytest.mark.parametrize("what", ["mu", "var", "grad"])
def test_batch_stats_are_the_global_batch_stats(world_run, what):
    """``_batch_stats`` under the data group against one process's
    statistics of the concatenated batch, and its gradient (each rank's
    share of x) against the gradient of the one-process objective: f32,
    summation order only (1e-6 relative, 1e-6 of the largest gradient)."""
    world, (data, _, ranks) = world_run
    x = data["stats_x"].clone().requires_grad_()
    mu, var = _batch_stats(x, (0, 2, 3))
    _stats_objective(mu, var, data["stats_w"]).backward()
    want = {"mu": mu.detach(), "var": var.detach(), "grad": x.grad}[what]
    if what == "grad":
        got = torch.cat([r["stats"]["grad"] for r in ranks])
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())
    else:
        for r in ranks:
            torch.testing.assert_close(r["stats"][what], want, rtol=1e-6, atol=1e-7)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
