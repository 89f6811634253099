"""The port's ViT across ranks (ddl_tpu_torch/train/vit_steps.py over
ddl_tpu_torch/parallel/lm_pipeline.py): every pipeline schedule -- gpipe,
1f1b, zb and the interleaved gpipe and 1f1b at V=2 over 4 layers --
against the one-process flat step and against each other, with dropout
too; a (data=2, pipe=2) world under gpipe; data parallelism at data=2 and
ZeRO-1 against it; and the schedules' clock and model.

The ranks are real processes over gloo on the CPU, started by the port's
spawner: a world of two ranks builds the (1, 2) mesh for the pipeline
cases and then the (2, 1) mesh for the data-parallel ones, and a world of
four ranks the (2, 2) mesh.  Each runs this file as a script
(``_rank_main``, torch only) and saves what it computed.  One AdamW step
(weight decay 0.05, global-norm clip 1.0, the example's optimizer) from
the seed's weights, in f32.  The JAX package's own tests hold its
pipeline to its flat step (``tests/test_vit.py``); here the limits are
its: the loss 1e-5 relative and every parameter 1e-4 of the largest
against the flat step, the schedules 1e-6 against each other, ZeRO
bit-equal to the replicated step (each element's sum over two ranks is
one addition)."""

import functools
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import launch
from ddl_tpu_torch.models.vit import ViTConfig
from ddl_tpu_torch.parallel.lm_pipeline import layer_chunks
from ddl_tpu_torch.parallel.mesh import build_lm_mesh
from ddl_tpu_torch.parallel.pipeline import HANDOFF, schedule_ticks
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.state import Optimizer
from ddl_tpu_torch.train.vit_steps import make_vit_step_fns

HERE = Path(__file__).resolve()
TINY = dict(image_size=32, patch_size=8, num_classes=5, d_model=64, n_layers=4, n_heads=4,
            head_dim=16, d_ff=128, compute_dtype="float32")
BATCH, SEED = 8, 0
LOSS_RTOL, PARAM_TOL, SCHEDULE_TOL = 1e-5, 1e-4, 1e-6


def _case(schedule, m, virtual=1, dropout=0.0, remat=True, same_rows=False):
    """``same_rows``: every data row is fed row-block 0, and the tensors the
    step averages over ``data`` are kept as they were before the average."""
    return dict(schedule=schedule, m=m, virtual=virtual, dropout=dropout, remat=remat,
                same_rows=same_rows)


# pipeline world (data, pipe) -> {case: case}
PIPE_CASES = {
    (1, 2): {
        "gpipe": _case("gpipe", 4),
        "1f1b": _case("1f1b", 4),
        "zb": _case("zb", 4),
        "gpipe_noremat": _case("gpipe", 4, remat=False),
        "zb_noremat": _case("zb", 4, remat=False),
        "interleaved_gpipe": _case("gpipe", 4, virtual=2),
        "interleaved_1f1b": _case("1f1b", 4, virtual=2),
        "gpipe_dropout": _case("gpipe", 4, dropout=0.1),
        "1f1b_dropout": _case("1f1b", 4, dropout=0.1),
        "zb_dropout": _case("zb", 4, dropout=0.1),
        "interleaved_1f1b_dropout": _case("1f1b", 4, virtual=2, dropout=0.1),
    },
    (2, 2): {
        "gpipe": _case("gpipe", 2),
        "gpipe_same_rows": _case("gpipe", 2, same_rows=True),
        "gpipe_dropout_same_rows": _case("gpipe", 2, dropout=0.1, same_rows=True),
    },
}
FLAT_CASES = ("replicated", "zero")


def _cfg(dropout=0.0, remat=True) -> ViTConfig:
    return ViTConfig(**TINY, dropout_rate=dropout, remat=remat)


def _adamw(params):
    return Optimizer(params, 1e-3, weight_decay=0.05, grad_clip_norm=1.0)


def _adam_fused(params):
    return Optimizer(params, 1e-3, fused=True)


def _batch():
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 5, BATCH).astype(np.int64))
    return images, labels


def _train_keeping_averaged(fns, state, images, labels):
    """``fns.train``, and the tensors it averaged over ``data`` as they were
    before the average."""
    from ddl_tpu_torch.parallel import lm_pipeline

    averaged, mean_over_data = [], lm_pipeline.mean_over_data

    def spy(tensors, mesh):
        averaged.append([t.clone() for t in tensors])
        return mean_over_data(tensors, mesh)

    lm_pipeline.mean_over_data = spy
    try:
        return (*fns.train(state, images, labels), averaged[0])
    finally:
        lm_pipeline.mean_over_data = mean_over_data


def _rank_main(out: str) -> None:
    """One rank: the pipeline cases of its world, then (two ranks) the
    data-parallel ones; saves ``rank<r>.pt``."""
    launch.bootstrap("cpu")
    world = torch.distributed.get_world_size()
    images, labels = _batch()
    result = {}
    spec = (1, 2) if world == 2 else (2, 2)
    mesh = build_lm_mesh(LMMeshSpec(data=spec[0], pipe=spec[1]), "cpu")
    rows = slice(mesh.data_index * BATCH // spec[0], (mesh.data_index + 1) * BATCH // spec[0])
    for name, case in PIPE_CASES[spec].items():
        fns = make_vit_step_fns(_cfg(case["dropout"], case["remat"]),
                                LMMeshSpec(data=spec[0], pipe=spec[1]), _adamw, SEED, BATCH,
                                num_microbatches=case["m"], pipeline_schedule=case["schedule"],
                                virtual_stages=case["virtual"], mesh=mesh)
        state = fns.init_state()
        HANDOFF.update(sends=0, recvs=0, bytes=0)
        if case["same_rows"]:
            block = slice(0, BATCH // spec[0])
            state, m, averaged = _train_keeping_averaged(fns, state, images[block],
                                                         labels[block])
            result[name] = {"loss": m["loss"].item(), "before_average": averaged}
            continue
        state, m = fns.train(state, images[rows], labels[rows])
        result[name] = {"loss": m["loss"].item(), "accuracy": m["accuracy"].item(),
                        "handoff": dict(HANDOFF), "state": state.model.state_dict(),
                        "logits": fns.evaluate(state, images[rows])}
    if world == 2:
        mesh = build_lm_mesh(LMMeshSpec(data=2), "cpu")
        rows = slice(mesh.rank * BATCH // 2, (mesh.rank + 1) * BATCH // 2)
        for name in FLAT_CASES:
            zero = name == "zero"
            fns = make_vit_step_fns(_cfg(), LMMeshSpec(data=2), _adam_fused, SEED, BATCH,
                                    zero_sharding=zero, mesh=mesh)
            state = fns.init_state()
            losses = []
            for _ in range(2):
                state, m = fns.train(state, images[rows], labels[rows])
                losses.append(m["loss"].item())
            result[f"dp_{name}"] = {"losses": losses, "state": state.model.state_dict(),
                                    "sharded": zero and state.optimizer.zero is not None}
    torch.save(result, Path(out) / f"rank{torch.distributed.get_rank()}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@functools.cache
def _run(n: int, root: str):
    Path(root).mkdir(parents=True, exist_ok=True)
    code = launch.spawn_local([sys.executable, str(HERE), root], n,
                              env=dict(os.environ, OMP_NUM_THREADS="1",
                                       PYTHONPATH=str(HERE.parents[1])),
                              log_dir=Path(root) / "logs", timeout_s=600)
    assert code == 0, (Path(root) / "logs" / "rank0.log").read_text()[-3000:]
    return [torch.load(Path(root) / f"rank{r}.pt", weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("vit_pipeline")
    return lambda n: _run(n, str(root / f"w{n}"))


@functools.cache
def _flat(steps: int = 1, opt=_adamw):
    """The one-process flat step: losses and the whole state."""
    fns = make_vit_step_fns(_cfg(), LMMeshSpec(), opt, SEED, BATCH, device="cpu")
    state = fns.init_state()
    images, labels = _batch()
    losses = []
    for _ in range(steps):
        state, m = fns.train(state, images, labels)
        losses.append(m["loss"].item())
    return losses, state.model.state_dict(), fns.evaluate(state, images)


def _whole(ranks_out, name, pipe):
    """A case's state: the union of data row 0's stages."""
    return {k: v for r in range(pipe) for k, v in ranks_out[r][name]["state"].items()}


def _max_err(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    scale = max(v.abs().max().item() for v in want.values())
    return max((got[k] - want[k]).abs().max().item() for k in want) / scale


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "zb", "gpipe_noremat", "zb_noremat",
                                  "interleaved_gpipe", "interleaved_1f1b"])
def test_each_schedule_matches_the_flat_step(ranks, name):
    out = ranks(2)
    losses, want, _ = _flat()
    for r in range(2):  # every stage of the row reports the step's metrics
        np.testing.assert_allclose(out[r][name]["loss"], losses[0], rtol=LOSS_RTOL)
    assert _max_err(_whole(out, name, 2), want) <= PARAM_TOL


@pytest.mark.parametrize("name", ["1f1b", "zb", "gpipe_noremat", "zb_noremat",
                                  "interleaved_gpipe", "interleaved_1f1b"])
def test_schedules_match_gpipe(ranks, name):
    """Each schedule against gpipe from the same weights: the same terms
    summed in the same order, so the same numbers (1e-6)."""
    out = ranks(2)
    ref = _whole(out, "gpipe", 2)
    assert abs(out[1][name]["loss"] - out[1]["gpipe"]["loss"]) <= SCHEDULE_TOL
    assert _max_err(_whole(out, name, 2), ref) <= SCHEDULE_TOL


@pytest.mark.parametrize("name", ["1f1b_dropout", "zb_dropout", "interleaved_1f1b_dropout"])
def test_dropout_masks_are_the_schedules_own(ranks, name):
    """Dropout on: each (step, microbatch, layer) mask comes from its own
    seed, so 1f1b, zb and the interleaved 1f1b equal gpipe (1e-6), and the
    step differs from the dropout-free one."""
    out = ranks(2)
    ref = _whole(out, "gpipe_dropout", 2)
    assert abs(out[1][name]["loss"] - out[1]["gpipe_dropout"]["loss"]) <= SCHEDULE_TOL
    assert _max_err(_whole(out, name, 2), ref) <= SCHEDULE_TOL
    assert abs(out[1][name]["loss"] - out[1]["gpipe"]["loss"]) > 1e-4


def test_eval_logits_match_the_flat_model(ranks):
    out = ranks(2)
    _, _, want = _flat()
    for name in ("gpipe", "interleaved_1f1b"):
        for r in range(2):
            got = out[r][name]["logits"]
            assert (got - want).abs().max().item() <= PARAM_TOL * want.abs().max().item()


def test_data_and_pipe_world_matches_the_flat_step(ranks):
    """(data=2, pipe=2) under gpipe, 2 microbatches of 4 (2 a row): the
    rows' step equals the flat step, and row 1 ends bit-equal to row 0."""
    out = ranks(4)
    losses, want, _ = _flat()
    for r in range(4):
        np.testing.assert_allclose(out[r]["gpipe"]["loss"], losses[0], rtol=LOSS_RTOL)
    assert _max_err(_whole(out, "gpipe", 2), want) <= PARAM_TOL
    for s in range(2):
        for k, v in out[s]["gpipe"]["state"].items():
            assert torch.equal(out[2 + s]["gpipe"]["state"][k], v), k


def test_data_rows_draw_their_own_dropout_masks(ranks):
    """(data=2, pipe=2), both rows fed the same rows: on each stage the two
    rows' gradients (and the last stage's metrics) before the average are
    equal without dropout and differ with dropout 0.1, since each row
    folds its coordinate into the step's dropout key."""
    out = ranks(4)
    for s in range(2):
        row0, row1 = (out[r]["gpipe_same_rows"]["before_average"] for r in (s, 2 + s))
        assert len(row0) == len(row1)
        assert all(torch.equal(a, b) for a, b in zip(row0, row1)), s
        row0, row1 = (out[r]["gpipe_dropout_same_rows"]["before_average"] for r in (s, 2 + s))
        assert not any(torch.equal(a, b) for a, b in zip(row0, row1)), s


def test_handoff_moves_each_unit_once_each_way(ranks):
    """A train step at M=4, P=2: under gpipe each microbatch's activation
    crosses forward and its cotangent back once; at V=2 each microbatch
    crosses the 3 boundaries of 4 global stages each way, the wrap (rank
    1's chunk 0 to rank 0's chunk 1) among them: 3 sends and 3 receives a
    microbatch on each rank."""
    out = ranks(2)
    for r in range(2):
        assert out[r]["gpipe"]["handoff"]["sends"] == 4
        assert out[r]["gpipe"]["handoff"]["recvs"] == 4
        assert out[r]["interleaved_1f1b"]["handoff"]["sends"] == 12
        assert out[r]["interleaved_1f1b"]["handoff"]["recvs"] == 12


def test_dp_matches_the_flat_step_and_zero_is_bit_equal(ranks):
    """data=2, plain fused Adam, 2 steps: the replicated step against the
    one-process step (1e-5, 1e-4); ZeRO-1 bit-equal to the replicated."""
    out = ranks(2)
    losses, want, _ = _flat(2, _adam_fused)
    rep, zero = out[0]["dp_replicated"], out[0]["dp_zero"]
    np.testing.assert_allclose(rep["losses"], losses, rtol=LOSS_RTOL)
    assert _max_err(rep["state"], want) <= PARAM_TOL
    assert zero["sharded"]
    assert zero["losses"] == rep["losses"]
    for r in range(2):
        for k, v in rep["state"].items():
            assert torch.equal(out[r]["dp_zero"]["state"][k], v), k
            assert torch.equal(out[r]["dp_replicated"]["state"][k], v), k


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("stages,virtual", [(2, 2), (2, 3), (3, 2), (4, 2)])
def test_interleaved_clock(schedule, stages, virtual):
    """Each (microbatch, global stage) runs its forward and backward once,
    a forward one tick after the previous global stage's (across the wrap
    too), a backward one tick after the next one's and no earlier than its
    own forward, and each chunk's backwards in microbatch order."""
    S = stages * virtual
    for m in (stages, 2 * stages, 3 * stages):
        ticks, at = schedule_ticks(schedule, stages, m, virtual)
        done = {}
        for s in range(stages):
            for t in range(ticks):
                for kind, unit in zip("FB", at(s, t)):
                    if unit is not None:
                        key = (kind, unit[0], unit[1] * stages + s)
                        assert key not in done
                        done[key] = t
        assert len(done) == 2 * S * m
        for (kind, mb, sig), t in done.items():
            if kind == "F":
                assert sig == 0 or done[("F", mb, sig - 1)] == t - 1
            else:
                assert done[("F", mb, sig)] <= t
                assert sig == S - 1 or done[("B", mb, sig + 1)] == t - 1
        for sig in range(S):
            assert [done[("B", mb, sig)] for mb in range(m)] == sorted(
                done[("B", mb, sig)] for mb in range(m))
    with pytest.raises(ValueError, match="groups of pipe"):
        schedule_ticks(schedule, stages, stages + 1, virtual)


def test_layer_chunks_place_global_stages():
    assert layer_chunks(4, 2, 1) == [[[0, 1]], [[2, 3]]]
    assert layer_chunks(4, 2, 2) == [[[0], [2]], [[1], [3]]]
    assert layer_chunks(12, 2, 3) == [[[0, 1], [4, 5], [8, 9]], [[2, 3], [6, 7], [10, 11]]]
    with pytest.raises(ValueError, match=re.escape("n_layers 4 % (pipe 2 * virtual 3) != 0")):
        layer_chunks(4, 2, 3)


@pytest.mark.parametrize("schedule,virtual", [("interleaved", 2), ("zb", 1)])
def test_schedule_summary_matches_the_jax_model(schedule, virtual):
    """The port's model of the interleaved and zb schedules gives the JAX
    package's summary over a grid of stages and microbatches."""
    from ddl_tpu.obs.schedule_model import schedule_summary as jax_summary
    from ddl_tpu_torch.obs.schedule_model import schedule_summary

    for pipe in (1, 2, 3, 4):
        for m in (pipe, 2 * pipe, 4 * pipe):
            assert schedule_summary(schedule, pipe, m, virtual) == jax_summary(
                schedule, pipe, m, virtual), (pipe, m)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
