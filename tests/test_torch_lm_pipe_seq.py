"""The LM pipeline with ``seq`` and with ``model`` inside its stages
(ddl_tpu_torch/parallel/lm_pipeline.py on the four-axis
``parallel.mesh.build_lm_mesh``) against the JAX package's
``make_lm_pipeline_step_fns`` (through its ``make_lm_step_fns``) on the
same mesh of its CPU devices, on ``tests/test_torch_lm_pipeline.py``'s
tiny f32 LM (4 layers, 2 heads of 8, vocab 32) at 8 x 16 tokens from the
JAX init's weights: (pipe 2, seq 2) with the ring, Ulysses and the ring
with flash (the JAX kernels in interpret mode, the port's plain versions)
under gpipe and 1f1b, and (pipe 2, model 2) under 1f1b, one Adam step in
two microbatches each: the loss, the eval metrics and every parameter
(each stage's model ranks joined, the stages merged), at that file's
limits (loss 1e-5 relative, parameters 1e-3 absolute:
``tests/test_lm_pipeline.py``'s).  Then, in the same world: the four
schedules (gpipe, 1f1b, zb, interleaved V=2) bit-equal to each other at
(pipe 2, seq 2) with dropout on; each sequence block drawing its own
dropout masks and the model ranks of a stage the same ones; and the JAX
checks that need ``seq`` above 1, now reached, with JAX's messages.

One world of four gloo ranks runs this file as a script (``_rank_main``,
torch only), started in the background while the JAX references compile
here."""

import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import launch
from ddl_tpu_torch.models.convert import gather_lm_state, shard_lm_state
from ddl_tpu_torch.models.transformer import LMConfig
from ddl_tpu_torch.parallel import lm_pipeline
from ddl_tpu_torch.parallel.lm_pipeline import make_lm_pipeline_step_fns, merge_lm_params
from ddl_tpu_torch.parallel.mesh import build_lm_mesh
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import local_block, make_lm_step_fns
from ddl_tpu_torch.train.state import Optimizer

HERE = Path(__file__).resolve()
TINY = dict(vocab_size=32, d_model=16, n_layers=4, n_heads=2, head_dim=8, d_ff=32,
            compute_dtype="float32", remat=False)
B, T, LR, M = 8, 16, 1e-2, 2
LOSS_TOL, PARAM_TOL = 1e-5, 1e-3
# name -> (mesh axes, attn_impl, flash, schedule, virtual)
CASES = {
    "ring-gpipe": (dict(pipe=2, seq=2), "ring", False, "gpipe", 1),
    "ring-1f1b": (dict(pipe=2, seq=2), "ring", False, "1f1b", 1),
    "ulysses-gpipe": (dict(pipe=2, seq=2), "ulysses", False, "gpipe", 1),
    "ulysses-1f1b": (dict(pipe=2, seq=2), "ulysses", False, "1f1b", 1),
    "ring_flash-gpipe": (dict(pipe=2, seq=2), "ring", True, "gpipe", 1),
    "ring_flash-1f1b": (dict(pipe=2, seq=2), "ring", True, "1f1b", 1),
    "model-1f1b": (dict(pipe=2, model=2), "dense", False, "1f1b", 1),
}
# the four schedules at (pipe 2, seq 2) over 4 microbatches with dropout
SCHEDULES = {"gpipe": ("gpipe", 1), "1f1b": ("1f1b", 1), "zb": ("zb", 1),
             "interleaved": ("gpipe", 2)}


def _adam(params):
    return Optimizer(params, LR)


def _batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, TINY["vocab_size"], (B, T + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _local(x, mesh):
    return torch.from_numpy(np.ascontiguousarray(local_block(x, mesh))).long()


def _one_step(mesh, params0, attn, flash, schedule, virtual, m=M, **cfg_kw):
    """One Adam step of this rank from ``params0`` (its stage's part, cut
    over ``model``), then the eval of the same batch."""
    cfg = LMConfig(**{**TINY, **cfg_kw}, attn_impl=attn, flash=flash)
    fns = make_lm_step_fns(cfg, mesh.spec, _adam, 0, B, T, device="cpu", mesh=mesh,
                           num_microbatches=m, pipeline_schedule=schedule,
                           virtual_stages=virtual)
    state = fns.init_state()
    part = shard_lm_state({"model": params0}, mesh.spec, mesh.model_index)["model"]
    state.model.load_state_dict({k: part[k] for k in state.model.state_dict()})
    inp, tgt = (_local(x, mesh) for x in _batch())
    state, met = fns.train(state, inp, tgt)
    ev = fns.evaluate(state, inp, tgt)
    return {"loss": met["loss"].item(), "eval": {k: v.item() for k, v in ev.items()},
            "state": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "at": (mesh.pipe_index, mesh.seq_index, mesh.model_index)}


def _rank_main(out: str) -> None:
    launch.bootstrap("cpu")
    root = Path(out)
    params0 = torch.load(root.parent / "params0.pt")
    meshes, result = {}, {}
    for name, (axes, attn, flash, schedule, virtual) in CASES.items():
        key = tuple(sorted(axes.items()))
        if key not in meshes:
            meshes[key] = build_lm_mesh(LMMeshSpec(**axes), "cpu")
        result[name] = _one_step(meshes[key], params0, attn, flash, schedule, virtual)
    # the schedules with dropout, spying on the masks' seeds
    seeds, real = [], lm_pipeline.mb_layer_seed

    def spy(key, m, layer):
        seeds.append((key, m, layer))
        return real(key, m, layer)

    lm_pipeline.mb_layer_seed = spy
    try:
        for name, (schedule, virtual) in SCHEDULES.items():
            result[f"dropout-{name}"] = _one_step(
                meshes[(("pipe", 2), ("seq", 2))], params0, "ring", False, schedule, virtual,
                m=4, dropout_rate=0.1)
        result["seeds-seq"] = sorted(set(seeds))
        seeds.clear()
        result["dropout-model"] = _one_step(meshes[(("model", 2), ("pipe", 2))], params0,
                                            "dense", False, "1f1b", 1, dropout_rate=0.1)
        result["seeds-model"] = sorted(set(seeds))
    finally:
        lm_pipeline.mb_layer_seed = real
    torch.save(result, root / f"rank{torch.distributed.get_rank()}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# ----------------------------------------------------------- the JAX side


@functools.cache
def _jax_params0():
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.models.transformer import TransformerLM as JaxTransformerLM

    tree = JaxTransformerLM(JaxLMConfig(**TINY)).init(jax.random.key(0),
                                                      jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(nn.meta.unbox(tree)))


@functools.cache
def _jax_case(name):
    """JAX's pipelined step on the case's mesh from the same weights: the
    loss, the eval metrics and the params after it, in the full layout."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.lm_pipeline import merge_lm_params as jax_merge
    from ddl_tpu.parallel.lm_pipeline import split_lm_params as jax_split
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns

    axes, attn, flash, schedule, virtual = CASES[name]
    spec = JaxMeshSpec(**axes)
    fns = jax_make_lm_step_fns(JaxLMConfig(**TINY, attn_impl=attn, flash=flash), spec,
                               optax.adam(LR), jax.random.key(0), B, T,
                               devices=jax.devices()[:spec.num_devices], num_microbatches=M,
                               pipeline_schedule=schedule, virtual_stages=virtual)
    state = fns.init_state()
    start = jax_split(_jax_params0(), spec.pipe, virtual)
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a, ref: jax.device_put(a, ref.sharding), start, state.params))
    inp, tgt = (jnp.asarray(x) for x in _batch())
    s1, m = fns.train(state, inp, tgt)
    ev = fns.evaluate(s1, inp, tgt)
    params = jax_merge(jax.tree_util.tree_map(np.asarray, jax.device_get(s1.params)))
    return float(m["loss"]), params, {k: float(v) for k, v in ev.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of four, started in the background once the weights are
    written; ``world()`` waits for it."""
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    root = tmp_path_factory.mktemp("lm_pipe_seq")
    torch.save(lm_params_from_jax(_jax_params0()), root / "params0.pt")
    pool = ThreadPoolExecutor(1)

    def spawn():
        out = root / "w4"
        out.mkdir()
        code = launch.spawn_local([sys.executable, str(HERE), str(out)], 4,
                                  env=dict(os.environ, OMP_NUM_THREADS="1",
                                           PYTHONPATH=str(HERE.parents[1])),
                                  log_dir=out / "logs", timeout_s=600)
        assert code == 0, (out / "logs" / "rank0.log").read_text()[-3000:]
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]

    running = pool.submit(spawn)
    yield running.result
    pool.shutdown()


def _joined(ranks, name) -> dict:
    """The one-device parameters: each stage's model ranks at sequence
    block 0 joined, the stages merged."""
    by = {r[name]["at"]: r[name]["state"] for r in ranks}
    models = sorted({a[2] for a in by})
    return merge_lm_params([
        gather_lm_state([{"model": by[(p, 0, m)]} for m in models],
                        vocab_size=TINY["vocab_size"])["model"]
        for p in sorted({a[0] for a in by})])


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_steps_match_jax_on_the_same_mesh(world, name):
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    want_loss, want_params, want_eval = _jax_case(name)
    ranks = world()
    for r in ranks:  # every rank reports the global metrics
        np.testing.assert_allclose(r[name]["loss"], want_loss, rtol=LOSS_TOL)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(r[name]["eval"][k], want_eval[k], rtol=LOSS_TOL,
                                       err_msg=k)
    got, want = _joined(ranks, name), lm_params_from_jax(want_params)
    assert got.keys() == want.keys()
    assert max((got[k] - want[k]).abs().max().item() for k in want) <= PARAM_TOL


def test_the_four_schedules_are_bit_equal_with_seq_and_dropout(world):
    ranks = world()
    want = _joined(ranks, "dropout-gpipe")
    for name in SCHEDULES:
        for r in ranks:
            assert r[f"dropout-{name}"]["loss"] == r["dropout-gpipe"]["loss"], name
        got = _joined(ranks, f"dropout-{name}")
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)


def test_each_sequence_block_draws_its_own_masks_and_model_ranks_share_them(world):
    """The masks' seeds (``mb_layer_seed``'s step keys): the two sequence
    blocks of a stage use different keys, the two model ranks of a stage
    the same ones."""
    ranks = world()
    keys = {r["dropout-gpipe"]["at"]: {s[0] for s in r["seeds-seq"]} for r in ranks}
    for p in range(2):
        assert keys[(p, 0, 0)] and keys[(p, 0, 0)].isdisjoint(keys[(p, 1, 0)])
    model = {r["dropout-model"]["at"]: r["seeds-model"] for r in ranks}
    for p in range(2):
        assert model[(p, 0, 0)] and model[(p, 0, 0)] == model[(p, 0, 1)]


def _jax_message(cfg_kw, spec_kw, **kw):
    import jax
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.lm_pipeline import make_lm_pipeline_step_fns as jax_factory
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec

    spec = JaxMeshSpec(**spec_kw)
    with pytest.raises(ValueError) as exc:
        jax_factory(JaxLMConfig(**{**TINY, **cfg_kw}), spec, optax.adam(LR),
                    jax.random.key(0), B, kw.pop("t", T), M,
                    devices=jax.devices()[:spec.num_devices], **kw)
    return str(exc.value)


@pytest.mark.parametrize("cfg_kw,spec_kw,kw", [
    (dict(flash=True), dict(pipe=2, seq=2), {}),
    (dict(attn_impl="ulysses", n_heads=3), dict(pipe=2, seq=2), {}),
    (dict(attn_impl="ring"), dict(pipe=2, seq=2), dict(t=15)),
    (dict(flash=True, n_heads=3), dict(pipe=2, model=2), {}),
], ids=["flash_dense_seq", "ulysses_heads", "seq_len", "flash_heads_model"])
def test_checks_that_need_seq_or_model_carry_jax_messages(cfg_kw, spec_kw, kw):
    """The JAX factory's checks that only a ``seq`` or ``model`` axis can
    trip, raised before any world is needed, JAX's message word for word."""
    want = _jax_message(cfg_kw, spec_kw, **dict(kw))
    t = kw.get("t", T)
    with pytest.raises(ValueError) as exc:
        make_lm_pipeline_step_fns(LMConfig(**{**TINY, **cfg_kw}), LMMeshSpec(**spec_kw), _adam,
                                  0, B, t, M, device="cpu")
    assert str(exc.value) == want


if __name__ == "__main__":
    _rank_main(sys.argv[1])
