"""The port's LM over a ``data`` x ``seq`` mesh (ddl_tpu_torch/train/
lm_steps.py, lm_trainer.py, examples/train_lm.py) against the JAX
package's ``make_lm_step_fns`` on the same mesh of its CPU devices, from
the same weights (``models/convert.lm_params_from_jax``) and the same
seeded batches: (data, seq) in {(2, 1), (1, 2), (2, 2)} with dense, ring
and Ulysses attention (and the ring with flash at (1, 2): the JAX kernels
in interpret mode, the port's plain versions), two AdamW steps each, the
losses, the eval metrics and every parameter.  Then the port's own
invariants on the (2, 2) mesh: every rank holds the same parameters,
ZeRO-1 and gradient accumulation land within the f32 floor of the plain
step, ``LMTrainer``'s resume is bit-equal in its own layout and within the
floor on one device, the example's ``--cpu-devices 4`` run matches the
example on one device, and rank ``s`` rotates its queries and keys at
global positions (its logits are the one-device model's; rotated from 0
they are not).

The ranks are real processes over gloo on the CPU, started by the port's
spawner: a world of two ranks (the (2, 1) and (1, 2) meshes) and a world
of four (the (2, 2) mesh), each rank running this file as a script
(``_rank_main``, torch only).  f32 on both sides; the limits are
``tests/test_torch_lm_train.py``'s: the losses to 1e-5 relative and every
parameter to 1e-5 absolute (the same math in another summation order),
and so the floor of a resume into another layout."""

import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import launch
from ddl_tpu_torch.models.transformer import LMConfig, TransformerLM
from ddl_tpu_torch.parallel.mesh import build_lm_mesh
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import local_block, make_lm_step_fns
from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer
from ddl_tpu_torch.train.state import Optimizer

HERE = Path(__file__).resolve()
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, compute_dtype="float32")
BATCH, SEQ, STEPS, LR = 4, 16, 2, 1e-3
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
# (data, seq) -> the attention impls (name -> (attn_impl, flash)) run there
CASES = {
    (2, 1): {"dense": ("dense", False), "ring": ("ring", False), "ulysses": ("ulysses", False)},
    (1, 2): {"dense": ("dense", False), "ring": ("ring", False), "ulysses": ("ulysses", False),
             "ring_flash": ("ring", True)},
    (2, 2): {"dense": ("dense", False), "ring": ("ring", False), "ulysses": ("ulysses", False)},
}
TRAINER = dict(TINY, vocab_size=256)  # the synthetic byte stream
TRAIN_RUN = dict(batch=BATCH, seq_len=SEQ, log_every=2, save_every=2, log_dir=None)
EXAMPLE = ["--d-model", "32", "--layers", "2", "--seq-len", "16", "--batch", "4", "--steps",
           "4", "--save-every", "2", "--log-every", "2", "--log-dir", "", "--job-id", "ex"]


def _adamw(params):
    """optax.adamw(LR): decoupled weight decay 1e-4 (optax's default)."""
    return Optimizer(params, LR, weight_decay=1e-4)


def _adam_fused(params):
    return Optimizer(params, LR, fused=True)


def _batches(n=STEPS, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, TINY["vocab_size"], (n, BATCH, SEQ + 1))
    return [(t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)) for t in toks]


def _local(x, mesh):
    return torch.from_numpy(np.ascontiguousarray(local_block(x, mesh)))


def _state_dict(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _steps(mesh, params0, attn, flash=False, **kw):
    """STEPS train steps of this rank on ``mesh`` from ``params0``, then
    the eval of the first batch: (losses, eval metrics, the state)."""
    tx = kw.pop("tx", _adamw)
    cfg = LMConfig(**TINY, attn_impl=attn, flash=flash)
    fns = make_lm_step_fns(cfg, mesh.spec, tx, 0, BATCH, SEQ, device="cpu", mesh=mesh, **kw)
    state = fns.init_state()
    state.model.load_state_dict(params0)
    losses = []
    for inp, tgt in _batches():
        state, m = fns.train(state, _local(inp, mesh), _local(tgt, mesh))
        losses.append(m["loss"].item())
    inp, tgt = _batches()[0]
    ev = {k: v.item() for k, v in fns.evaluate(state, _local(inp, mesh),
                                               _local(tgt, mesh)).items()}
    return {"losses": losses, "eval": ev, "state": _state_dict(state.model)}


def _trainer(mesh, root, job, steps, **kw):
    run = LMRunConfig(**TRAIN_RUN, steps=steps, checkpoint_dir=str(root / "ck"), job_id=job,
                      **kw)
    t = LMTrainer(LMConfig(**TRAINER, attn_impl="ring"), mesh.spec, _adamw, run, device="cpu",
                  mesh=mesh)
    t.train()
    return _state_dict(t.state.model)


def _rank_main(out: str) -> None:
    """One rank: the cases of its world's meshes; in the world of four the
    ZeRO-1 and accumulation steps, the trainer's runs and the rope check;
    saves ``rank<r>.pt``."""
    launch.bootstrap("cpu")
    root = Path(out)
    world = torch.distributed.get_world_size()
    params0 = torch.load(root.parent / "params0.pt")
    result = {}
    for layout in [k for k in CASES if k[0] * k[1] == world]:
        mesh = build_lm_mesh(LMMeshSpec(data=layout[0], seq=layout[1]), "cpu")
        for name, (attn, flash) in CASES[layout].items():
            result[layout, name] = _steps(mesh, params0, attn, flash)
    if world == 2:
        # rope at global positions: rank s's logits against the one-device
        # model's, and with the rotation from 0
        fns = make_lm_step_fns(LMConfig(**TINY), mesh.spec, _adamw, 0, BATCH, SEQ,
                               device="cpu", mesh=mesh)
        model = fns.init_state().model
        model.load_state_dict(params0)
        inp = _local(_batches()[0][0], mesh)
        with torch.no_grad():
            result["rope"] = model(inp)[0]
            for block in model.blocks():
                block.attn.seq_index = 0
            result["rope_from_0"] = model(inp)[0]
    else:
        result["zero"] = _steps(mesh, params0, "ring", tx=_adam_fused, zero_sharding=True)
        result["fused"] = _steps(mesh, params0, "ring", tx=_adam_fused)
        result["accum"] = _steps(mesh, params0, "ring", accum_steps=2)
        result["whole"] = _trainer(mesh, root, "whole", 4)
        _trainer(mesh, root, "cut", 2)
        result["resumed"] = _trainer(mesh, root, "cut", 4)
        result["ck"] = str(root / "ck")
    torch.save(result, root / f"rank{torch.distributed.get_rank()}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@functools.cache
def _params0():
    """The JAX init's weights (numpy tree) for ``TINY``."""
    import jax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns
    import optax

    fns = jax_make_lm_step_fns(JaxLMConfig(**TINY), JaxMeshSpec(), optax.adamw(LR),
                               jax.random.key(0), BATCH, SEQ)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(fns.init_state().params))


@functools.cache
def _run(root: str, n: int):
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    root = Path(root)
    if not (root / "params0.pt").exists():
        torch.save(lm_params_from_jax(_params0()), root / "params0.pt")
    out = root / f"w{n}"
    out.mkdir(parents=True, exist_ok=True)
    code = launch.spawn_local([sys.executable, str(HERE), str(out)], n,
                              env=dict(os.environ, OMP_NUM_THREADS="1",
                                       PYTHONPATH=str(HERE.parents[1])),
                              log_dir=out / "logs", timeout_s=600)
    assert code == 0, (out / "logs" / "rank0.log").read_text()[-3000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lm_mesh"))
    return lambda n: _run(root, n)


@functools.cache
def _jax(layout, attn, flash):
    """JAX's per-step losses, eval metrics and final parameters on the
    (data, seq) mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns

    cfg = JaxLMConfig(**TINY, attn_impl=attn, flash=flash)
    fns = jax_make_lm_step_fns(cfg, JaxMeshSpec(data=layout[0], seq=layout[1]),
                               optax.adamw(LR), jax.random.key(0), BATCH, SEQ)
    state = fns.init_state()
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a, ref: jax.device_put(a, ref.sharding), _params0(), state.params))
    losses = []
    for inp, tgt in _batches():
        state, m = fns.train(state, jnp.asarray(inp), jnp.asarray(tgt))
        losses.append(float(m["loss"]))
    inp, tgt = _batches()[0]
    ev = {k: float(v) for k, v in fns.evaluate(state, jnp.asarray(inp), jnp.asarray(tgt)).items()}
    return losses, ev, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


def _max_diff(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max((got[k] - want[k]).abs().max().item() for k in want)


@pytest.mark.parametrize("layout, name", [(k, n) for k, v in CASES.items() for n in v],
                         ids=[f"{k[0]}x{k[1]}-{n}" for k, v in CASES.items() for n in v])
def test_steps_match_jax_on_the_same_mesh(world, layout, name):
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    out = world(layout[0] * layout[1])
    want_losses, want_eval, want_params = _jax(layout, *CASES[layout][name])
    want = lm_params_from_jax(want_params)
    for r in out:  # every rank reports the global metrics and holds the same weights
        got = r[layout, name]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
        for k in ("loss", "ce", "accuracy"):
            np.testing.assert_allclose(got["eval"][k], want_eval[k], rtol=LOSS_RTOL, err_msg=k)
        assert _max_diff(got["state"], want) <= PARAM_ATOL


def test_zero_and_accumulation_within_the_floor(world):
    """ZeRO-1 over data (after the mean over seq) and two accumulation
    chunks a rank, against the plain step on the (2, 2) mesh."""
    out = world(4)
    for r in out:
        np.testing.assert_allclose(r["zero"]["losses"], r["fused"]["losses"], rtol=LOSS_RTOL)
        assert _max_diff(r["zero"]["state"], r["fused"]["state"]) <= PARAM_ATOL
        np.testing.assert_allclose(r["accum"]["losses"], r[(2, 2), "ring"]["losses"],
                                   rtol=LOSS_RTOL)
        assert _max_diff(r["accum"]["state"], r[(2, 2), "ring"]["state"]) <= PARAM_ATOL


def test_trainer_resume_bit_equal_in_its_layout_and_within_the_floor_on_one_device(world):
    out = world(4)
    for r in out:
        for k, v in r["whole"].items():
            assert torch.equal(r["resumed"][k], v), k
            assert torch.equal(out[0]["whole"][k], v), k
    run = LMRunConfig(**TRAIN_RUN, steps=4, checkpoint_dir=out[0]["ck"], job_id="cut",
                      resume_step=2)
    t = LMTrainer(LMConfig(**TRAINER, attn_impl="ring"), LMMeshSpec(), _adamw, run,
                  device="cpu")
    assert t.state.step == 2
    t.train()
    assert _max_diff(_state_dict(t.state.model), out[0]["whole"]) <= PARAM_ATOL


def test_rope_rotates_global_positions(world):
    """Rank 1 of the (1, 2) mesh holds positions 8..15: its logits are the
    one-device model's there; rotated from position 0 they are not."""
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    out = world(2)
    model = TransformerLM(LMConfig(**TINY))
    model.load_state_dict(lm_params_from_jax(_params0()))
    with torch.no_grad():
        whole = model(torch.from_numpy(_batches()[0][0]))[0]
    half = SEQ // 2
    for s, r in enumerate(out):
        want = whole[:, s * half:(s + 1) * half]
        assert (r["rope"] - want).abs().max().item() <= 1e-5
    assert (out[1]["rope_from_0"] - whole[:, half:]).abs().max().item() > 1e-3


def test_example_cpu_devices_matches_one_device(tmp_path, monkeypatch):
    """``train_lm --cpu-devices 4 --data 2 --seq 2 --attn ring`` (four gloo
    ranks) and the same command on one device: the step-4 snapshots within
    the floor."""
    from ddl_tpu_torch import checkpoint as ckpt
    from ddl_tpu_torch.examples import train_lm

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(HERE.parents[1])
    run = [*EXAMPLE, "--attn", "ring"]
    assert train_lm.main([*run, "--checkpoint-dir", str(tmp_path / "mesh"), "--cpu-devices",
                          "4", "--data", "2", "--seq", "2"]) is None
    train_lm.main([*run, "--checkpoint-dir", str(tmp_path / "one"), "--device", "cpu"])
    got, _ = ckpt.load_snapshot(tmp_path / "mesh", "ex", 4)
    want, _ = ckpt.load_snapshot(tmp_path / "one", "ex", 4)
    assert got["step"] == want["step"] == 4
    assert _max_diff(got["model"], want["model"]) <= PARAM_ATOL


def test_bench_lm_mesh_parity_on_the_cpu(capfd, monkeypatch):
    """``bench/lm.py --cpu-devices 2 --seq 2 --attn ulysses --parity`` (the
    four-card bench's command at a tiny size, bf16 on the CPU): rank 0's
    line with the mesh, its parity with one device and f32 held."""
    import json

    from ddl_tpu_torch.bench import lm as bench_lm

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(HERE.parents[1])
    assert bench_lm.main(["--cpu-devices", "2", "--seq", "2", "--attn", "ulysses", "--flash",
                          "on", "--parity", "--batch", "2", "--seq-len", "32", "--d-model",
                          "128", "--layers", "1", "--vocab", "64", "--iters", "1"]) is None
    row = json.loads(next(line for line in capfd.readouterr().out.splitlines()
                          if line.startswith('{"ms_per_step"')))
    assert (row["data"], row["seq"], row["attn"], row["flash"]) == (1, 2, "ulysses", True)
    assert row["parity"]["ok"] and len(row["parity"]["losses"]["mesh"]) == 3


if __name__ == "__main__":
    _rank_main(sys.argv[1])
