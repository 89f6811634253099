"""Tensor parallelism over ``model`` (ddl_tpu_torch/models/transformer.py's
tensor-parallel blocks, train/lm_steps.py, ops/losses.vocab_parallel_ce,
train/state.py's clip norm, models/convert.shard_lm_state) against the JAX
package's ``make_lm_step_fns`` on the same mesh of its CPU devices, from
the same weights (``lm_params_from_jax``, then each rank's cut) and the
same seeded batches: model 2 (dense, flash, and a vocabulary that model
does not divide), (data 2, model 2) and (seq 2, model 2) with the ring and
with Ulysses, two AdamW steps each with the global-norm clip on, the
losses, the eval metrics and every parameter gathered over ``model``.
Then the port's own invariants: with dropout on, every leaf the table
replicates is bit-equal across the model ranks; ZeRO-1 at (data 2, model
2) within the floor of the plain fused step; the trainer's snapshot of a
model-2 run restored on one device and a one-device snapshot resumed
under model 2; ``train_lm --model 2 --cpu-devices 2`` against the example
on one device.  The ViT at model 2 (two-rank world) and at (pipe 2, model
2) (four-rank world) rides along, against JAX ``make_vit_step_fns``.

The ranks are real processes over gloo on the CPU, started by the port's
spawner: a world of two ranks, then one of four, one after the other.
f32 on both sides; the limits are ``tests/test_torch_lm_mesh.py``'s: the
losses to 1e-5 relative and every parameter to 1e-5 absolute (the ViT:
one AdamW step, every parameter to 1e-4 of the largest,
``tests/test_torch_vit.py``'s protocol and limit)."""

import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import launch
from ddl_tpu_torch.models.convert import gather_lm_state, gather_vit_state
from ddl_tpu_torch.models.transformer import LMConfig
from ddl_tpu_torch.parallel.mesh import build_lm_mesh
from ddl_tpu_torch.parallel.rules import lm_rules
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import local_block, make_lm_step_fns
from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer
from ddl_tpu_torch.train.state import Optimizer

HERE = Path(__file__).resolve()
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, compute_dtype="float32")
BATCH, SEQ, STEPS, LR, CLIP = 4, 16, 2, 1e-3, 0.5
LOSS_RTOL, PARAM_ATOL, VIT_PARAM_TOL = 1e-5, 1e-5, 1e-4
# name -> (data, seq, model), config overrides, attn_impl, flash
CASES = {
    "m2-dense": ((1, 1, 2), {}, "dense", False),
    "m2-flash": ((1, 1, 2), {}, "dense", True),
    "m2-odd-vocab": ((1, 1, 2), dict(vocab_size=63), "dense", False),
    "d2m2-dense": ((2, 1, 2), {}, "dense", False),
    "s2m2-ring": ((1, 2, 2), {}, "ring", False),
    "s2m2-ulysses": ((1, 2, 2), dict(n_kv_heads=0), "ulysses", False),
}
VIT = dict(image_size=32, patch_size=8, num_classes=5, d_model=64, n_layers=2, n_heads=4,
           head_dim=16, d_ff=128, compute_dtype="float32")  # tests/test_torch_vit.py's
VIT_BATCH = 8
# the ViT cases: name -> (LMMeshSpec fields, the step factory's keywords);
# both are held to JAX's flat step at model 2 (a pipeline computes the flat
# step's function)
VIT_CASES = {"vit-m2": (dict(model=2), {}),
             "vit-p2m2": (dict(pipe=2, model=2), dict(pipeline_schedule="1f1b",
                                                      num_microbatches=2))}
TRAINER = dict(TINY, vocab_size=256)  # the synthetic byte stream
TRAIN_RUN = dict(batch=BATCH, seq_len=SEQ, log_every=2, save_every=2, log_dir=None)
EXAMPLE = ["--d-model", "32", "--layers", "2", "--seq-len", "16", "--batch", "4", "--steps",
           "4", "--save-every", "2", "--log-every", "2", "--log-dir", "", "--job-id", "ex"]


def _adamw(params):
    """optax.chain(clip_by_global_norm(CLIP), adamw(LR))."""
    return Optimizer(params, LR, weight_decay=1e-4, grad_clip_norm=CLIP)


def _adam_fused(params):
    return Optimizer(params, LR, fused=True)


def _cfg(name, **extra):
    _, over, attn, flash = CASES[name]
    return dict(TINY, **over, **extra), attn, flash


def _batches(vocab=64, n=STEPS, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, BATCH, SEQ + 1))
    return [(t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)) for t in toks]


def _local(x, mesh):
    return torch.from_numpy(np.ascontiguousarray(local_block(x, mesh)))


def _state_dict(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _vit_batches(n=1, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (VIT_BATCH, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 5, VIT_BATCH).astype(np.int32)) for _ in range(n)]


def _steps(mesh, params0, cfg_kw, attn, flash, tx=_adamw, steps=STEPS, **kw):
    """``steps`` train steps of this rank from ``params0`` (the one-device
    weights, cut by the factory's own init path), then the eval of the
    first batch."""
    from ddl_tpu_torch.models.convert import shard_lm_state

    cfg = LMConfig(**cfg_kw, attn_impl=attn, flash=flash)
    fns = make_lm_step_fns(cfg, mesh.spec, tx, 0, BATCH, SEQ, device="cpu", mesh=mesh, **kw)
    state = fns.init_state()
    if params0 is not None:
        state.model.load_state_dict(shard_lm_state({"model": params0}, mesh.spec,
                                                   mesh.model_index)["model"])
    batches = _batches(cfg.vocab_size, n=steps)
    losses = []
    for inp, tgt in batches:
        state, m = fns.train(state, _local(inp, mesh), _local(tgt, mesh))
        losses.append(m["loss"].item())
    inp, tgt = batches[0]
    ev = {k: v.item() for k, v in fns.evaluate(state, _local(inp, mesh),
                                               _local(tgt, mesh)).items()}
    return {"losses": losses, "eval": ev, "state": _state_dict(state.model),
            "at": (mesh.data_index, mesh.pipe_index, mesh.seq_index, mesh.model_index)}


def _vit_steps(mesh, params0, **kw):
    from ddl_tpu_torch.models.convert import shard_vit_state
    from ddl_tpu_torch.models.vit import ViT, ViTConfig
    from ddl_tpu_torch.train.vit_steps import make_vit_step_fns

    def tx(params):
        return Optimizer(params, LR, weight_decay=1e-4)

    fns = make_vit_step_fns(ViTConfig(**VIT), mesh.spec, tx, 0, VIT_BATCH, device="cpu",
                            mesh=mesh, **kw)
    state = fns.init_state()
    part = shard_vit_state({"model": params0}, mesh.spec, mesh.model_index)["model"]
    state.model.load_state_dict({k: part[k] for k in state.model.state_dict()})
    assert isinstance(state.model, ViT)
    losses = []
    for images, labels in _vit_batches():
        state, m = fns.train(state, torch.from_numpy(images), torch.from_numpy(labels).long())
        losses.append(m["loss"].item())
    return {"losses": losses, "state": _state_dict(state.model),
            "at": (mesh.data_index, mesh.pipe_index, 0, mesh.model_index)}


def _trainer(mesh, root, job, steps, **kw):
    run = LMRunConfig(**TRAIN_RUN, steps=steps, checkpoint_dir=str(root.parent / "ck"),
                      job_id=job, **kw)
    t = LMTrainer(LMConfig(**TRAINER), mesh.spec if mesh else LMMeshSpec(), _adamw, run,
                  device="cpu", mesh=mesh)
    t.train()
    return _state_dict(t.state.model)


def _rank_main(out: str) -> None:
    """One rank: its world's cases; in the world of two the dropout
    invariant, the ViT at model 2 and the trainer's runs; in the world of
    four ZeRO-1 and the ViT at (pipe 2, model 2); saves ``rank<r>.pt``."""
    launch.bootstrap("cpu")
    root = Path(out)
    world = torch.distributed.get_world_size()
    params0 = torch.load(root.parent / "params0.pt")
    result = {}
    meshes = {}
    for name, (layout, over, attn, flash) in CASES.items():
        if np.prod(layout) != world:
            continue
        if layout not in meshes:
            meshes[layout] = build_lm_mesh(LMMeshSpec(data=layout[0], seq=layout[1],
                                                      model=layout[2]), "cpu")
        p0 = params0["odd"] if over.get("vocab_size") == 63 else params0[
            "mha" if over.get("n_kv_heads") == 0 else "gqa"]
        result[name] = _steps(meshes[layout], p0, *_cfg(name))
    for name, (spec_kw, kw) in VIT_CASES.items():
        spec = LMMeshSpec(**spec_kw)
        if spec.num_devices == world:
            result[name] = _vit_steps(build_lm_mesh(spec, "cpu"), params0["vit"], **kw)
    if world == 2:
        mesh = meshes[(1, 1, 2)]
        result["dropout"] = _steps(mesh, params0["gqa"], *_cfg("m2-dense", dropout_rate=0.3))
        result["whole"] = _trainer(mesh, root, "whole", 4)
        _trainer(mesh, root, "cut", 2)
        result["resumed"] = _trainer(mesh, root, "cut", 4)
        result["from_one"] = _trainer(mesh, root, "one", 4)
    else:
        mesh = meshes[(2, 1, 2)]
        result["zero"] = _steps(mesh, params0["gqa"], *_cfg("d2m2-dense"), tx=_adam_fused,
                                zero_sharding=True)
        result["fused"] = _steps(mesh, params0["gqa"], *_cfg("d2m2-dense"), tx=_adam_fused)
    torch.save(result, root / f"rank{torch.distributed.get_rank()}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@functools.cache
def _params0(kind: str):
    """The JAX init's weights (numpy tree) for ``TINY`` (``gqa``), its MHA
    variant (``mha``), a vocabulary of 63 (``odd``) or the ViT (``vit``)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    if kind == "vit":
        from ddl_tpu.models.vit import ViT as JaxViT
        from ddl_tpu.models.vit import ViTConfig as JaxViTConfig

        tree = JaxViT(JaxViTConfig(**VIT)).init(jax.random.key(0),
                                                jnp.zeros((1, 32, 32, 3)))["params"]
    else:
        from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
        from ddl_tpu.models.transformer import TransformerLM as JaxTransformerLM

        over = {"gqa": {}, "mha": dict(n_kv_heads=0), "odd": dict(vocab_size=63)}[kind]
        tree = JaxTransformerLM(JaxLMConfig(**dict(TINY, **over))).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(nn.meta.unbox(tree)))


def _torch_params0(kind: str) -> dict:
    from ddl_tpu_torch.models.convert import lm_params_from_jax, vit_params_from_jax

    return (vit_params_from_jax if kind == "vit" else lm_params_from_jax)(_params0(kind))


@functools.cache
def _run(root: str, n: int):
    root = Path(root)
    if not (root / "params0.pt").exists():
        torch.save({k: _torch_params0(k) for k in ("gqa", "mha", "odd", "vit")},
                   root / "params0.pt")
        # a one-device snapshot at step 2 for the model-2 world to resume
        _trainer(None, root / "one", "one", 2)
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
    root = str(tmp_path_factory.mktemp("lm_tensor"))

    def run(n):
        return _run(root, n)

    run.root = Path(root)
    return run


@functools.cache
def _jax(name):
    """JAX's per-step losses, eval metrics and final parameters on the
    case's (data, seq, model) mesh of CPU devices."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns

    layout, over, _, _ = CASES[name]
    cfg_kw, attn, flash = _cfg(name)
    cfg = JaxLMConfig(**cfg_kw, attn_impl=attn, flash=flash)
    tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR))
    fns = jax_make_lm_step_fns(cfg, JaxMeshSpec(data=layout[0], seq=layout[1],
                                                model=layout[2]),
                               tx, jax.random.key(0), BATCH, SEQ)
    kind = "odd" if over.get("vocab_size") == 63 else (
        "mha" if over.get("n_kv_heads") == 0 else "gqa")
    state = fns.init_state()
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a, ref: jax.device_put(a, ref.sharding), _params0(kind), state.params))
    batches = _batches(cfg.vocab_size)
    losses = []
    for inp, tgt in batches:
        state, m = fns.train(state, jnp.asarray(inp), jnp.asarray(tgt))
        losses.append(float(m["loss"]))
    inp, tgt = batches[0]
    ev = {k: float(v) for k, v in fns.evaluate(state, jnp.asarray(inp), jnp.asarray(tgt)).items()}
    return losses, ev, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


def _gathered(ranks, key, vocab=None, vit=False) -> dict:
    """The one-device parameters from the ranks at data 0 and seq 0 (each
    stage's model ranks joined, the stages merged)."""
    by = {r[key]["at"]: r[key]["state"] for r in ranks}
    pipes = sorted({a[1] for a in by})
    models = sorted({a[3] for a in by})
    full = {}
    for p in pipes:
        parts = [{"model": by[(0, p, 0, m)]} for m in models]
        full.update((gather_vit_state(parts) if vit else gather_lm_state(parts, vocab))["model"])
    return full


def _max_diff(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max((got[k] - want[k]).abs().max().item() for k in want)


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax_on_the_same_mesh(world, name):
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    out = world(int(np.prod(CASES[name][0])))
    want_losses, want_eval, want_params = _jax(name)
    vocab = _cfg(name)[0]["vocab_size"]
    for r in out:  # every rank reports the global metrics
        got = r[name]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
        for k in ("loss", "ce", "accuracy"):
            np.testing.assert_allclose(got["eval"][k], want_eval[k], rtol=LOSS_RTOL, err_msg=k)
    assert _max_diff(_gathered(out, name, vocab), lm_params_from_jax(want_params)) <= PARAM_ATOL


@functools.cache
def _jax_vit():
    import jax
    import jax.numpy as jnp
    import optax

    from ddl_tpu.models.vit import ViTConfig as JaxViTConfig
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.vit_steps import make_vit_step_fns as jax_make_vit_step_fns

    fns = jax_make_vit_step_fns(JaxViTConfig(**VIT), JaxMeshSpec(model=2), optax.adamw(LR),
                                jax.random.key(0), VIT_BATCH)
    state = fns.init_state()
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a, ref: jax.device_put(a, ref.sharding), _params0("vit"), state.params))
    losses = []
    for images, labels in _vit_batches():
        state, m = fns.train(state, jnp.asarray(images), jnp.asarray(labels))
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


@pytest.mark.parametrize("name", list(VIT_CASES))
def test_vit_steps_match_jax(world, name):
    from ddl_tpu_torch.models.convert import vit_params_from_jax

    out = world(LMMeshSpec(**VIT_CASES[name][0]).num_devices)
    want_losses, want_params = _jax_vit()
    for r in out:
        np.testing.assert_allclose(r[name]["losses"], want_losses, rtol=LOSS_RTOL)
    want = vit_params_from_jax(want_params)
    scale = max(v.abs().max().item() for v in want.values())
    assert _max_diff(_gathered(out, name, vit=True), want) <= VIT_PARAM_TOL * scale


def test_dropout_keeps_the_replicated_leaves_equal_across_model_ranks(world):
    """Residual dropout acts on the activations every model rank holds, so
    its masks are the same there: after two steps every leaf ``lm_rules``
    replicates (the norms) is bit-equal on both ranks, and the run differs
    from the run without dropout."""
    out = world(2)
    specs = lm_rules().specs(out[0]["dropout"]["state"])
    replicated = [k for k, s in specs.items() if "model" not in s]
    assert replicated and len(replicated) < len(specs)
    for k in replicated:
        assert torch.equal(out[0]["dropout"]["state"][k], out[1]["dropout"]["state"][k]), k
    assert out[0]["dropout"]["losses"] != out[0]["m2-dense"]["losses"]


def test_zero_at_data_2_model_2_within_the_floor(world):
    for r in world(4):
        np.testing.assert_allclose(r["zero"]["losses"], r["fused"]["losses"], rtol=LOSS_RTOL)
        assert _max_diff(r["zero"]["state"], r["fused"]["state"]) <= PARAM_ATOL


def test_trainer_snapshots_cross_between_model_2_and_one_device(world, tmp_path):
    """A model-2 run resumed in its own layout is bit-equal to the
    uninterrupted one; its step-2 snapshot (one-device layout) resumed on
    one device, and a one-device step-2 snapshot resumed under model 2,
    land within the floor of the uninterrupted runs."""
    out = world(2)
    for r in out:
        for k, v in r["whole"].items():
            assert torch.equal(r["resumed"][k], v), k
    run = LMRunConfig(**TRAIN_RUN, steps=4, checkpoint_dir=str(world.root / "ck"), job_id="cut",
                      resume_step=2)
    t = LMTrainer(LMConfig(**TRAINER), LMMeshSpec(), _adamw, run, device="cpu")
    assert t.state.step == 2
    t.train()
    whole = {"model": out[0]["whole"]}
    other = {"model": out[1]["whole"]}
    joined = gather_lm_state([whole, other], vocab_size=256)["model"]
    assert _max_diff(_state_dict(t.state.model), joined) <= PARAM_ATOL
    # the one-device run to step 4 against the model-2 run resumed from its step 2
    one = LMTrainer(LMConfig(**TRAINER), LMMeshSpec(), _adamw,
                    LMRunConfig(**TRAIN_RUN, steps=4, checkpoint_dir=str(tmp_path),
                                job_id="one"), device="cpu")
    one.train()
    from_one = gather_lm_state([{"model": out[0]["from_one"]}, {"model": out[1]["from_one"]}],
                               vocab_size=256)["model"]
    assert _max_diff(from_one, _state_dict(one.state.model)) <= PARAM_ATOL


def test_example_model_2_matches_one_device(tmp_path, monkeypatch):
    """``train_lm --model 2 --cpu-devices 2`` (two gloo ranks) and the same
    command on one device: the step-4 snapshots within the floor."""
    from ddl_tpu_torch import checkpoint as ckpt
    from ddl_tpu_torch.examples import train_lm

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(HERE.parents[1])
    assert train_lm.main([*EXAMPLE, "--checkpoint-dir", str(tmp_path / "mesh"),
                          "--cpu-devices", "2", "--model", "2"]) is None
    train_lm.main([*EXAMPLE, "--checkpoint-dir", str(tmp_path / "one"), "--device", "cpu"])
    got, _ = ckpt.load_snapshot(tmp_path / "mesh", "ex", 4)
    want, _ = ckpt.load_snapshot(tmp_path / "one", "ex", 4)
    assert got["step"] == want["step"] == 4
    assert _max_diff(got["model"], want["model"]) <= PARAM_ATOL


@pytest.mark.parametrize("consumer", ["make_lm_step_fns", "make_lm_pipeline_step_fns",
                                      "LMTrainer", "train_lm", "make_vit_step_fns",
                                      "train_vit"])
def test_fsdp_over_data_refuses_and_is_a_no_op_on_one_device(consumer):
    """``fsdp`` is carried for JAX's configs; over a data axis above 1 the
    port refuses it (ROADMAP item 11b, FSDP) instead of training
    replicated, before any world is needed; on one device it shards
    nothing, as in JAX, and the step runs."""
    from ddl_tpu_torch.examples import train_lm, train_vit
    from ddl_tpu_torch.models.vit import ViTConfig
    from ddl_tpu_torch.parallel.lm_pipeline import make_lm_pipeline_step_fns
    from ddl_tpu_torch.train.vit_steps import make_vit_step_fns

    cfg = LMConfig(**TINY, fsdp=True)
    vit = ViTConfig(**VIT, fsdp=True)
    refuse = {
        "make_lm_step_fns": lambda: make_lm_step_fns(cfg, LMMeshSpec(data=2), _adamw, 0, BATCH,
                                                     SEQ, device="cpu"),
        "make_lm_pipeline_step_fns": lambda: make_lm_pipeline_step_fns(
            cfg, LMMeshSpec(data=2, pipe=2), _adamw, 0, BATCH, SEQ, 2, device="cpu"),
        "LMTrainer": lambda: LMTrainer(LMConfig(**TRAINER, fsdp=True), LMMeshSpec(data=2),
                                       _adamw, LMRunConfig(log_dir=None), device="cpu"),
        "train_lm": lambda: train_lm.main([*EXAMPLE, "--fsdp", "--data", "2"]),
        "make_vit_step_fns": lambda: make_vit_step_fns(vit, LMMeshSpec(data=2), _adamw, 0,
                                                       VIT_BATCH, device="cpu"),
        "train_vit": lambda: train_vit.main(["--fsdp", "--data", "2"]),
    }[consumer]
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 11b \(FSDP\)"):
        refuse()
    if consumer == "make_lm_step_fns":
        fns = make_lm_step_fns(cfg, LMMeshSpec(), _adamw, 0, BATCH, SEQ, device="cpu")
        inp, tgt = (torch.from_numpy(a).long() for a in _batches()[0])
        state, m = fns.train(fns.init_state(), inp, tgt)
        assert state.step == 1 and np.isfinite(m["loss"].item())


@pytest.mark.parametrize("consumer", ["make_lm_step_fns", "make_lm_pipeline_step_fns",
                                      "make_vit_step_fns"])
def test_a_mesh_that_does_not_lay_out_the_spec_is_refused(consumer):
    """A step factory given a mesh laid out for another spec (a ``(data,
    pipe)`` ``Mesh``, or an ``LMMesh`` without the ``model`` axis the spec
    asks for) raises instead of training replicated."""
    from ddl_tpu_torch.models.vit import ViTConfig
    from ddl_tpu_torch.parallel.lm_pipeline import make_lm_pipeline_step_fns
    from ddl_tpu_torch.parallel.mesh import LMMesh, Mesh, MeshSpec
    from ddl_tpu_torch.train.vit_steps import make_vit_step_fns

    cpu = torch.device("cpu")
    cfg = LMConfig(**TINY)
    build = {
        "make_lm_step_fns": lambda spec, mesh: make_lm_step_fns(
            cfg, spec, _adamw, 0, BATCH, SEQ, device="cpu", mesh=mesh),
        "make_lm_pipeline_step_fns": lambda spec, mesh: make_lm_pipeline_step_fns(
            cfg, spec, _adamw, 0, BATCH, SEQ, 2, device="cpu", mesh=mesh),
        "make_vit_step_fns": lambda spec, mesh: make_vit_step_fns(
            ViTConfig(**VIT), spec, _adamw, 0, VIT_BATCH, device="cpu", mesh=mesh),
    }[consumer]
    pipe = 2 if consumer == "make_lm_pipeline_step_fns" else 1
    spec = LMMeshSpec(pipe=pipe, model=2)
    for mesh in (Mesh(MeshSpec(1, pipe), cpu), LMMesh(LMMeshSpec(pipe=pipe), cpu)):
        with pytest.raises(ValueError, match="does not lay out the step's mesh"):
            build(spec, mesh)


def test_row_parallel_part_sums_bf16_operands_in_f32():
    """``QDense.partial_sum`` (a row-parallel part) returns the f32 sums of
    the bf16 operands' products, unrounded, and its backward gives the
    bf16 gradients one card's bf16 product gives for the same cotangent."""
    from ddl_tpu_torch.models.transformer import QDense

    torch.manual_seed(0)
    dense = QDense(48, 24, torch.bfloat16)
    x = torch.randn(2, 5, 48, dtype=torch.bfloat16, requires_grad=True)
    y = dense.partial_sum(x)
    want = x.detach().float() @ dense.kernel.detach().to(torch.bfloat16).float()
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    g = torch.randn(2, 5, 24).to(torch.bfloat16)
    y.backward(g.float())
    x1 = x.detach().clone().requires_grad_()
    k1 = dense.kernel.detach().clone().requires_grad_()
    (x1 @ k1.to(torch.bfloat16)).backward(g)
    torch.testing.assert_close(x.grad, x1.grad, rtol=0, atol=0)
    torch.testing.assert_close(dense.kernel.grad, k1.grad, rtol=0, atol=0)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
