"""The port's LM pipeline (ddl_tpu_torch/parallel/lm_pipeline.py: the
layout functions and ``make_lm_pipeline_step_fns``, through
``train/lm_steps.make_lm_step_fns``, ``LMTrainer`` and
``examples/train_lm.py``) against the JAX package's
(``ddl_tpu/parallel/lm_pipeline.py``) on the JAX test's tiny f32 LM
(``tests/test_lm_pipeline.py``: 4 layers, 2 heads of 8, d_ff 32, vocab 32,
batch 8 x 8 from a numpy seed), from the JAX init's weights
(``models/convert.lm_params_from_jax``).

* The layout functions against JAX's on the same numpy trees, exactly:
  ``split_lm_params``/``merge_lm_params`` at V=1 and V=2,
  ``saved_pipe_stages``/``saved_virtual_stages``, ``convert_lm_state``
  with Adam's moments.
* One world of two gloo ranks (pipe 2): one Adam step under gpipe (M=2),
  1f1b, zb and the interleaved gpipe (V=2, M=2), each against JAX's
  ``make_lm_step_fns(LMMeshSpec(pipe=2), num_microbatches=2)`` at that
  test's limits (loss 1e-5, every parameter 1e-3) with the eval against
  JAX's ``evaluate``, and the four bit-equal to each other; ``ce_chunk``
  under gpipe and 1f1b and ``ce_vocab_chunk`` under gpipe against JAX's
  one-device step; ``LMTrainer``'s
  snapshots at pipe 2 resumed under V=2 (in the world) and under one
  device (here), every tensor bit-equal to the file and the runs within
  the f32 floor of the uninterrupted one; ``train_lm --pipe 2
  --cpu-devices 2 --device cpu`` and its relaunch.  In the same world a
  ``(data, seq) = (1, 2)`` mesh runs item 11a's two rank-local paths:
  ``nan@grad`` rolling back and a corpus's held-out eval, against the
  JAX trainer on the same mesh.
* One world of four ranks (data 2, pipe 2), started when the first has
  ended: one gpipe step against JAX's ``dp2_pp2``; then both data rows fed
  the same rows, where the rows' gradients before the average are equal
  without dropout and differ with it (each row its own masks), and 1f1b,
  zb and the interleaved gpipe are gpipe's bit for bit with dropout.
* The factory's checks at ``seq`` 1 with JAX's messages; expert
  parallelism and MoE get the port's item 11c refusal (``seq`` and
  ``model`` inside the stages: tests/test_torch_lm_pipe_seq.py).

The worlds run this file as a script (``_rank_main``, torch only), started
in the background when the module's first test asks, while the JAX
references compile here."""

import dataclasses
import functools
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch import launch
from ddl_tpu_torch.models.transformer import LMConfig, TransformerLM
from ddl_tpu_torch.parallel.lm_pipeline import (
    convert_lm_state,
    make_lm_pipeline_step_fns,
    merge_lm_params,
    saved_pipe_stages,
    saved_virtual_stages,
    split_lm_params,
)
from ddl_tpu_torch.parallel.mesh import build_lm_mesh
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_steps import local_block, make_lm_step_fns
from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer
from ddl_tpu_torch.train.state import Optimizer

HERE = Path(__file__).resolve()
TINY = dict(vocab_size=32, d_model=16, n_layers=4, n_heads=2, head_dim=8, d_ff=32,
            compute_dtype="float32", attn_impl="dense", remat=False)
B, T, LR = 8, 8, 1e-2
LOSS_TOL, PARAM_TOL = 1e-5, 1e-3  # tests/test_lm_pipeline.py:92-97
# the world of two ranks: name -> (schedule, virtual, microbatches, cfg overrides)
PIPE_CASES = {
    "gpipe": ("gpipe", 1, 2, {}),
    "1f1b": ("1f1b", 1, 2, {}),
    "zb": ("zb", 1, 2, {}),
    "interleaved": ("gpipe", 2, 2, {}),
    "gpipe_ce_chunk": ("gpipe", 1, 2, {"ce_chunk": 4}),
    "1f1b_ce_chunk": ("1f1b", 1, 2, {"ce_chunk": 4}),
    "gpipe_ce_vocab_chunk": ("gpipe", 1, 2, {"ce_vocab_chunk": 16}),
}
SCHEDULES = ("gpipe", "1f1b", "zb", "interleaved")
# the world of four ranks (data 2, pipe 2), both data rows fed the same
# rows: without dropout, and every schedule with dropout 0.1
DROPOUT_CASES = {"same_rows": ("gpipe", 1, 2, {}),
                 **{f"dropout_{name}": (*PIPE_CASES[name][:3], {"dropout_rate": 0.1})
                    for name in SCHEDULES}}
# LMTrainer's runs (the synthetic byte stream needs vocab 256): uninterrupted
# to step 5; cut at its step-3 snapshot; resumed under V=2 and one device
TRAINER = dict(TINY, vocab_size=256)
TRAIN_RUN = dict(batch=B, seq_len=T, log_every=1, save_every=3, log_dir=None,
                 num_microbatches=2, pipeline_schedule="1f1b")
STEPS, CUT = 5, 3
EXAMPLE = ["--cpu-devices", "2", "--device", "cpu", "--pipe", "2", "--microbatches", "4",
           "--pipeline-schedule", "zb", "--d-model", "16", "--layers", "2", "--seq-len", "8",
           "--batch", "8", "--save-every", "2", "--log-every", "2", "--log-dir", "",
           "--job-id", "ex"]
# item 11a's runs at (data, seq) = (1, 2): the ring, a byte corpus with a
# held-out tail, nan@grad at step 4 (step 5 reads NaN) rolled back to the step-4
# snapshot
SEQ_CFG = dict(vocab_size=256, d_model=32, n_layers=1, n_heads=4, head_dim=8, d_ff=64,
               compute_dtype="float32", attn_impl="ring")
SEQ_RUN = dict(batch=4, seq_len=16, steps=8, log_every=2, eval_every=4, eval_frac=0.25,
               save_every=2, nan_policy="recover", nan_max_consecutive=1,
               nan_grace_scale=0.1, nan_grace_periods=1, job_id="lm-nan")
NAN = "nan@grad:4"


def _adam(params):
    """optax.adam(1e-2)."""
    return Optimizer(params, LR)


def _adamw(params):
    """optax.adamw(1e-3): decoupled weight decay 1e-4 (optax's default)."""
    return Optimizer(params, 1e-3, weight_decay=1e-4)


def _batch(seed=0):
    toks = np.random.default_rng(seed).integers(0, 32, (B, T + 1))
    return toks[:, :-1], toks[:, 1:]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x)).long()


def _clone(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def _corpus(root: Path) -> str:
    """2000 seeded bytes: 124 windows of 16+1 tokens, the last 31 held out."""
    path = root / "corpus.txt"
    if not path.exists():
        path.write_bytes(np.random.default_rng(7).integers(0, 256, 2000,
                                                           dtype=np.uint8).tobytes())
    return str(path)


def _load(model, params):
    model.load_state_dict({k: params[k] for k in model.state_dict()})


def _pipe_case(mesh, params0, name, data=1):
    """One step of case ``name`` on this rank; a ``DROPOUT_CASES`` one
    feeds every data row row-block 0 and keeps the tensors the step
    averages over ``data`` as they were before the average."""
    from ddl_tpu_torch.parallel import lm_pipeline

    same_rows = name in DROPOUT_CASES
    schedule, virtual, m, kw = (DROPOUT_CASES if same_rows else PIPE_CASES)[name]
    fns = make_lm_step_fns(LMConfig(**TINY, **kw), LMMeshSpec(data=data, pipe=2), _adam, 0, B,
                           T, num_microbatches=m, pipeline_schedule=schedule,
                           virtual_stages=virtual, mesh=mesh)
    state = fns.init_state()
    _load(state.model, params0)
    inp, tgt = (_t(x[:B // data] if same_rows else local_block(x, mesh)) for x in _batch())
    averaged, mean_over_data = [], lm_pipeline.mean_over_data

    def spy(tensors, mesh):
        averaged.append([t.clone() for t in tensors])
        return mean_over_data(tensors, mesh)

    lm_pipeline.mean_over_data = spy
    try:
        state, m = fns.train(state, inp, tgt)
    finally:
        lm_pipeline.mean_over_data = mean_over_data
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    ev = fns.evaluate(state, inp, tgt)
    return {"loss": m["loss"].item(), "state": _clone(state.model.state_dict()),
            "grads": grads, "eval": {k: v.item() for k, v in ev.items()},
            "before_average": averaged[0]}


def _trainer(spec, root, job, steps, mesh=None, **kw):
    run = LMRunConfig(**{**TRAIN_RUN, **kw}, steps=steps, checkpoint_dir=str(root / "ck"),
                      job_id=job)
    t = LMTrainer(LMConfig(**TRAINER), spec, _adam, run, device="cpu", mesh=mesh)
    restored = t.snapshot_state()  # the live tensors: copied before the steps
    if restored is not None:
        restored = ckpt.map_tensors(restored, lambda _, x: x.detach().clone())
    t.train()
    return t, restored


def _seq_trainer(mesh, root):
    """Item 11a's trainer at (1, 2): the JAX init's weights, ``nan@grad``."""
    from ddl_tpu_torch.utils import faultinject

    faultinject.activate(NAN)
    run = LMRunConfig(**SEQ_RUN, corpus=_corpus(root), checkpoint_dir=str(root / "seq_ck"),
                      log_dir=str(root / "seq_logs"))
    t = LMTrainer(LMConfig(**SEQ_CFG), mesh.spec, _adamw, run, device="cpu", mesh=mesh)
    t.state.model.load_state_dict(torch.load(root.parent / "seq_params0.pt"))
    t.train()
    faultinject.deactivate()
    return {"step": t.state.step, "rollbacks": t.recovery.rollbacks,
            "scale": getattr(t, "update_scale", None)}


def _rank_main(out: str) -> None:
    """One rank: the cases of its world; saves ``rank<r>.pt``."""
    from ddl_tpu_torch.examples import train_lm

    launch.bootstrap("cpu")
    root = Path(out)
    world = torch.distributed.get_world_size()
    params0 = torch.load(root.parent / "params0.pt")
    result = {}
    if world == 4:
        mesh = build_lm_mesh(LMMeshSpec(data=2, pipe=2), "cpu")
        result["dp2_pp2"] = _pipe_case(mesh, params0, "gpipe", data=2)
        for name in DROPOUT_CASES:
            result[name] = _pipe_case(mesh, params0, name, data=2)
    else:
        mesh = build_lm_mesh(LMMeshSpec(pipe=2), "cpu")
        for name in PIPE_CASES:
            result[name] = _pipe_case(mesh, params0, name)
        spec = LMMeshSpec(pipe=2)
        whole, _ = _trainer(spec, root, "whole", STEPS, mesh)
        _trainer(spec, root, "cut", CUT, mesh)
        v2, restored = _trainer(spec, root, "cut", STEPS, mesh, virtual_stages=2)
        result["trainer"] = {"whole": whole.snapshot_state(), "v2": v2.snapshot_state(),
                             "v2_restored": restored, "v2_start": v2._start_step}
        example = train_lm.main([*EXAMPLE, "--steps", "2", "--checkpoint-dir",
                                 str(root / "ex")])
        relaunch = train_lm.main([*EXAMPLE, "--steps", "4", "--checkpoint-dir",
                                  str(root / "ex")])
        result["example"] = {"steps": (example.state.step, relaunch.state.step),
                             "start": relaunch._start_step,
                             "stage": sorted(relaunch.state.model.state_dict())}
        result["seq"] = _seq_trainer(build_lm_mesh(LMMeshSpec(seq=2), "cpu"), root)
    torch.save(result, root / f"rank{torch.distributed.get_rank()}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# ----------------------------------------------------------- the JAX side


@functools.cache
def _jax_init(ce_chunk: int = 0, ce_vocab_chunk: int = 0):
    """JAX's one-device step from its init: (init params, params after one
    adam(1e-2) step, loss, eval metrics), numpy trees."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns

    fns = jax_make_lm_step_fns(JaxLMConfig(**TINY, ce_chunk=ce_chunk,
                                           ce_vocab_chunk=ce_vocab_chunk), JaxMeshSpec(),
                               optax.adam(LR), jax.random.key(0), B, T,
                               devices=jax.devices()[:1])
    s0 = fns.init_state()
    p0 = jax.tree_util.tree_map(np.asarray, jax.device_get(s0.params))
    inp, tgt = (jnp.asarray(x) for x in _batch())
    s1, m = fns.train(s0, inp, tgt)
    return p0, jax.tree_util.tree_map(np.asarray, jax.device_get(s1.params)), float(m["loss"])


@functools.cache
def _jax_pipe(schedule: str, virtual: int, data: int = 1):
    """JAX's pipelined step (pipe 2, two microbatches): the loss, the
    params after it in the full layout, and the eval metrics."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.lm_pipeline import merge_lm_params as jax_merge
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns

    spec = JaxMeshSpec(data=data, pipe=2)
    fns = jax_make_lm_step_fns(JaxLMConfig(**TINY), spec, optax.adam(LR), jax.random.key(0),
                               B, T, devices=jax.devices()[:spec.num_devices],
                               num_microbatches=2, pipeline_schedule=schedule,
                               virtual_stages=virtual)
    inp, tgt = (jnp.asarray(x) for x in _batch())
    s1, m = fns.train(fns.init_state(), inp, tgt)
    ev = fns.evaluate(s1, inp, tgt)
    params = jax_merge(jax.tree_util.tree_map(np.asarray, jax.device_get(s1.params)))
    return float(m["loss"]), params, {k: float(v) for k, v in ev.items()}


@functools.cache
def _jax_seq_trainer(root: str) -> dict:
    """The JAX trainer of item 11a's run on the (1, 2) mesh; its initial
    weights go to the ranks."""
    import jax
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.lm_trainer import LMRunConfig as JaxRunConfig
    from ddl_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
    from ddl_tpu.utils import faultinject as jax_faultinject
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    root = Path(root)
    jax_faultinject.activate(NAN)
    run = JaxRunConfig(**SEQ_RUN, corpus=_corpus(root), checkpoint_dir=str(root / "jax_ck"),
                       log_dir=str(root / "jax_logs"))
    t = JaxLMTrainer(JaxLMConfig(**SEQ_CFG), JaxMeshSpec(seq=2), optax.adamw(1e-3), run,
                     jax.random.key(0))
    torch.save(lm_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(t.state.params))), root / "seq_params0.pt")
    return t, jax_faultinject


# ------------------------------------------------------------ the worlds


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started in the background one after the other (at most
    two ranks beside this process) once the weights are written;
    ``worlds(n)`` waits for the world of ``n`` ranks."""
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    root = tmp_path_factory.mktemp("lm_pipeline")
    torch.save(lm_params_from_jax(_jax_init()[0]), root / "params0.pt")
    jax_seq = _jax_seq_trainer(str(root))
    pool = ThreadPoolExecutor(1)

    def spawn(n):
        out = root / f"w{n}"
        out.mkdir()
        _corpus(out)  # before the ranks, which read it
        code = launch.spawn_local([sys.executable, str(HERE), str(out)], n,
                                  env=dict(os.environ, OMP_NUM_THREADS="1",
                                           PYTHONPATH=str(HERE.parents[1])),
                                  log_dir=out / "logs", timeout_s=600)
        assert code == 0, (out / "logs" / "rank0.log").read_text()[-3000:]
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]

    futures = {n: pool.submit(spawn, n) for n in (2, 4)}
    # the JAX trainer runs while the ranks do
    jax_t, jax_faultinject = jax_seq
    jax_t.train()
    jax_faultinject.deactivate()
    got = {"root": root, "jax_seq": jax_t}
    yield lambda n: got.setdefault(n, futures[n].result()) if n in (2, 4) else got[n]
    pool.shutdown()


def _whole(ranks, name, stages=(0, 1)):
    return merge_lm_params([ranks[r][name]["state"] for r in stages])


def _jax_full(tree):
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    return lm_params_from_jax(tree)


def _max_err(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max((got[k] - want[k]).abs().max().item() for k in want)


@pytest.mark.parametrize("name", SCHEDULES)
def test_each_schedule_matches_jax(worlds, name):
    """One step under each schedule against JAX's pipeline at (pipe 2, M
    2): loss 1e-5, every parameter 1e-3, the eval's loss, CE and accuracy
    1e-5, on both stages."""
    schedule, virtual, _, _ = PIPE_CASES[name]
    loss, params, ev = _jax_pipe(schedule, virtual)
    ranks = worlds(2)
    for r in range(2):
        assert abs(ranks[r][name]["loss"] - loss) < LOSS_TOL
        for k in ("loss", "ce", "accuracy"):
            assert abs(ranks[r][name]["eval"][k] - ev[k]) < LOSS_TOL, k
    assert _max_err(_whole(ranks, name), _jax_full(params)) < PARAM_TOL


@pytest.mark.parametrize("name", ["1f1b", "zb", "interleaved"])
def test_schedules_are_bit_equal(worlds, name):
    """The same terms in the same order: each schedule's gradients, step
    and loss are gpipe's bit for bit."""
    ranks = worlds(2)
    for r in range(2):
        assert ranks[r][name]["loss"] == ranks[r]["gpipe"]["loss"]
    for part in ("grads", "state"):
        got, want = ({k: v for r in range(2) for k, v in ranks[r][case][part].items()}
                     for case in (name, "gpipe"))
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), (part, k)


@pytest.mark.parametrize("name", ["gpipe_ce_chunk", "1f1b_ce_chunk", "gpipe_ce_vocab_chunk"])
def test_ce_chunk_matches_the_jax_step(worlds, name):
    """``ce_chunk`` under gpipe and 1f1b and ``ce_vocab_chunk`` under gpipe
    (each microbatch's chunked head+CE on the last stage) against JAX's
    one-device step with the same loss edge, at the JAX pipeline test's
    limits."""
    _, params, loss = _jax_init(**PIPE_CASES[name][3])
    ranks = worlds(2)
    assert abs(ranks[1][name]["loss"] - loss) < LOSS_TOL
    assert abs(ranks[1][name]["eval"]["loss"] - ranks[1]["gpipe"]["eval"]["loss"]) < LOSS_TOL
    assert _max_err(_whole(ranks, name), _jax_full(params)) < PARAM_TOL


def test_data_and_pipe_world_matches_jax(worlds):
    """(data 2, pipe 2): one gpipe step against JAX's ``dp2_pp2``; data
    row 1 ends bit-equal to row 0."""
    loss, params, ev = _jax_pipe("gpipe", 1, data=2)
    ranks = worlds(4)
    for r in range(4):
        assert abs(ranks[r]["dp2_pp2"]["loss"] - loss) < LOSS_TOL
        assert abs(ranks[r]["dp2_pp2"]["eval"]["ce"] - ev["ce"]) < LOSS_TOL
    assert _max_err(_whole(ranks, "dp2_pp2"), _jax_full(params)) < PARAM_TOL
    for s in range(2):
        for k, v in ranks[s]["dp2_pp2"]["state"].items():
            assert torch.equal(ranks[2 + s]["dp2_pp2"]["state"][k], v), k


def test_data_rows_draw_their_own_dropout_masks(worlds):
    """(data 2, pipe 2), both rows fed the same rows: on each stage the
    two rows' gradients (and the last stage's loss) before the average
    are equal without dropout and differ with dropout 0.1, since each row
    folds its coordinate into the step's dropout key."""
    ranks = worlds(4)
    for s in range(2):
        row0, row1 = (ranks[r]["same_rows"]["before_average"] for r in (s, 2 + s))
        assert len(row0) == len(row1)
        assert all(torch.equal(a, b) for a, b in zip(row0, row1)), s
        row0, row1 = (ranks[r]["dropout_gpipe"]["before_average"] for r in (s, 2 + s))
        assert not any(torch.equal(a, b) for a, b in zip(row0, row1)), s


@pytest.mark.parametrize("name", ["1f1b", "zb", "interleaved"])
def test_schedules_with_dropout_are_bit_equal_over_data(worlds, name):
    """Dropout 0.1 at (data 2, pipe 2): each schedule's loss, gradients and
    step are gpipe's bit for bit on every data row."""
    ranks = worlds(4)
    for r in range(4):
        assert ranks[r][f"dropout_{name}"]["loss"] == ranks[r]["dropout_gpipe"]["loss"]
    for row in ((0, 1), (2, 3)):
        for part in ("grads", "state"):
            got, want = ({k: v for r in row for k, v in ranks[r][case][part].items()}
                         for case in (f"dropout_{name}", "dropout_gpipe"))
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert torch.equal(got[k], v), (row, part, k)


def test_trainer_resumes_across_layouts(worlds):
    """``LMTrainer`` at pipe 2 (1f1b): the step-3 snapshot (the one-device
    layout, gathered from both stages) resumes under V=2 in the world and
    under one device here; each restores every tensor bit-equal to the
    file and ends within 1e-5 of the uninterrupted run (the same math, the
    stages' sums in another order)."""
    ranks, root = worlds(2), worlds("root")
    tr = ranks[0]["trainer"]
    saved, _ = ckpt.load_snapshot(root / "w2" / "ck", "cut", CUT)
    assert tr["v2_start"] == CUT and ranks[1]["trainer"]["v2_restored"] is None
    one, restored = _trainer(LMMeshSpec(), root / "w2", "cut", STEPS, num_microbatches=0,
                             pipeline_schedule="gpipe")
    assert one._start_step == CUT
    for got in (tr["v2_restored"], restored):
        assert got["step"] == saved["step"] == CUT
        assert list(got["model"]) == list(saved["model"])
        for k, v in saved["model"].items():
            assert torch.equal(got["model"][k], v), k
        for i, st in saved["optimizer"]["inner"]["state"].items():
            for k, v in st.items():
                assert torch.equal(got["optimizer"]["inner"]["state"][i][k], v), (i, k)
    whole = tr["whole"]["model"]
    assert list(whole) == list(saved["model"])
    for final in (tr["v2"]["model"], one.snapshot_state()["model"]):
        assert _max_err(final, whole) < 1e-5


def test_generator_decodes_a_pipelined_snapshot(worlds):
    """The pipelined trainer's step-3 snapshot holds the one-device layout:
    the decode tools' check takes it, a whole model loads it key for key,
    and the generator decodes it."""
    from ddl_tpu_torch.checkpoint import load_params, require_one_device_layout
    from ddl_tpu_torch.infer import make_lm_generator

    worlds(2)
    params = load_params(worlds("root") / "w2" / "ck", "whole", CUT, vocab_size=256)
    require_one_device_layout(params, "generate_lm")
    TransformerLM(LMConfig(**TRAINER)).load_state_dict(params)  # strict: every key
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 4)))
    toks = make_lm_generator(LMConfig(**TRAINER), prompt_len=4, max_new=3, batch=2,
                             device="cpu")(params, prompt)
    assert toks.shape == (2, 3) and 0 <= int(toks.min()) and int(toks.max()) < 256


def test_example_trains_and_resumes_over_two_stages(worlds):
    """``train_lm --pipe 2 --cpu-devices 2 --device cpu`` (zb, 4
    microbatches): two steps with a snapshot, then the relaunch resumes it
    and takes two more; rank 1 holds the second stage only."""
    ranks = worlds(2)
    for r in range(2):
        assert ranks[r]["example"]["steps"] == (2, 4)
        assert ranks[r]["example"]["start"] == 2
    modules = [{k.split(".")[0] for k in ranks[r]["example"]["stage"]} for r in range(2)]
    assert modules == [{"embed", "block0"}, {"block1", "norm_f", "lm_head"}]


def _csv(root, job, metric):
    import csv

    with open(Path(root) / "by_job_id" / job / f"{metric}.csv", newline="") as f:
        return [(int(r[5]), float(r[6])) for r in csv.reader(f)]


def test_nan_grad_rolls_back_at_seq_2_as_jax(worlds):
    """Item 11a's gap: ``nan@grad:4`` at (data, seq) = (1, 2) with
    ``nan_policy="recover"``: one rollback to the step-4 snapshot on both
    packages, the same final step and update scale, and rank 0's loss rows
    within 1e-5 of JAX's on the same mesh."""
    ranks, root, jax_t = worlds(2), worlds("root"), worlds("jax_seq")
    want = {"step": int(jax_t.state.step), "rollbacks": jax_t.recovery.rollbacks,
            "scale": getattr(jax_t, "update_scale", None)}
    assert want["rollbacks"] >= 1
    for r in range(2):
        assert ranks[r]["seq"] == want
    got, want = _csv(root / "w2" / "seq_logs", "lm-nan", "loss"), _csv(
        root / "jax_logs", "lm-nan", "loss")
    assert [e for e, _ in got] == [e for e, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)


def test_heldout_eval_at_seq_2_matches_jax(worlds):
    """Item 11a's gap: the corpus's held-out ``val_loss``/``val_ppl``
    (``LMTrainer.evaluate_period``) at (1, 2), each eval batch's CE over
    the global batch, against the JAX trainer's rows."""
    root = worlds("root")
    worlds(2)
    for metric in ("val_loss", "val_ppl"):
        got = _csv(root / "w2" / "seq_logs", "lm-nan", metric)
        want = _csv(root / "jax_logs", "lm-nan", metric)
        assert got and [e for e, _ in got] == [e for e, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)


# -------------------------------------------------------- the layouts


def _jax_tree(n_layers=4, seed=0):
    """A numpy params tree of the JAX model's structure, every leaf drawn."""
    rng = np.random.default_rng(seed)
    block = {"attn": {n: {"kernel": None} for n in "qkvo"},
             "mlp": {"wi": {"kernel": None}, "wo": {"kernel": None}},
             "norm_attn": {"scale": None}, "norm_mlp": {"scale": None}}

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else rng.standard_normal(
            (3, 2) if k == "kernel" else (2,)).astype(np.float32) for k, v in t.items()}

    tree = {"embed": {"embedding": None}}  # the model's order
    tree.update({f"block{i}": block for i in range(n_layers)})
    tree.update({"norm_f": {"scale": None}, "lm_head": {"kernel": None}})
    return fill(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("stages,virtual", [(2, 1), (4, 1), (2, 2)])
def test_split_and_merge_match_jax_exactly(stages, virtual):
    """Stage ``s``'s ``block{(c*P + s)*k + j}`` is JAX's ``blocks[s, (c,)
    j]``; ``embed`` on stage 0, ``norm_f``/``lm_head`` on the last; the
    merge restores the whole tree in the model's key order."""
    from ddl_tpu.parallel.lm_pipeline import merge_lm_params as jax_merge
    from ddl_tpu.parallel.lm_pipeline import saved_pipe_stages as jax_saved_pipe
    from ddl_tpu.parallel.lm_pipeline import saved_virtual_stages as jax_saved_virtual
    from ddl_tpu.parallel.lm_pipeline import split_lm_params as jax_split
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    tree = _jax_tree()
    full = lm_params_from_jax(tree)
    parts = split_lm_params(full, stages, virtual)
    pp = jax_split(tree, stages, virtual)
    blocks = _flat(pp["blocks"]["interleaved"] if virtual > 1 else pp["blocks"])
    k = 4 // (stages * virtual)
    for s, part in enumerate(parts):
        want = {}
        for c in range(virtual):
            for j in range(k):
                ell = (c * stages + s) * k + j
                want.update({f"block{ell}.{name}": (arr[s, c, j] if virtual > 1 else arr[s, j])
                             for name, arr in blocks.items()})
        if s == 0:
            want.update({f"embed.{n}": a for n, a in _flat(pp["embed"]["embed"]).items()})
        if s == stages - 1:
            want.update({f"{h}.{n}": a for h in ("norm_f", "lm_head")
                         for n, a in _flat(pp["head"][h]).items()})
        assert part.keys() == want.keys()
        for name, arr in want.items():
            assert np.array_equal(part[name].numpy(), arr), name
    merged = merge_lm_params(parts)
    assert list(merged) == list(full)
    assert all(torch.equal(merged[n], full[n]) for n in full)
    assert set(_flat(jax_merge(pp))) == set(full)
    assert saved_pipe_stages(parts) == jax_saved_pipe(pp) == stages
    assert saved_virtual_stages(parts) == jax_saved_virtual(pp) == virtual
    assert saved_pipe_stages(full) == jax_saved_pipe(tree) == 1
    assert saved_virtual_stages(full) == jax_saved_virtual(tree) == 1


@pytest.mark.parametrize("virtual", [1, 2])
def test_convert_lm_state_matches_jax_with_adam_moments(virtual):
    """``convert_lm_state`` on a state after one Adam step: the stages'
    models and Adam moments are JAX's converted ``params``/``mu``/``nu``
    exactly, and converting back restores the state."""
    import jax
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.lm_pipeline import convert_lm_state as jax_convert
    from ddl_tpu.parallel.lm_pipeline import merge_lm_params as jax_merge
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns
    from ddl_tpu_torch.models.convert import lm_params_from_jax

    fns = jax_make_lm_step_fns(JaxLMConfig(**TINY), JaxMeshSpec(), optax.adam(LR),
                               jax.random.key(0), B, T, devices=jax.devices()[:1])
    s1, _ = fns.train(fns.init_state(), *(jax.numpy.asarray(x) for x in _batch()))
    s1 = jax.device_get(s1)
    adam = s1.opt_state[0]
    model = lm_params_from_jax(s1.params)
    model = {k: model[k] for k in TransformerLM(LMConfig(**TINY)).state_dict()}
    mu, nu = lm_params_from_jax(adam.mu), lm_params_from_jax(adam.nu)
    state = {"model": model, "step": 1, "optimizer": {"count": 1, "inner": {
        "param_groups": [{"lr": LR, "params": list(range(len(model)))}],
        "state": {i: {"step": torch.tensor(1.0), "exp_avg": mu[k], "exp_avg_sq": nu[k]}
                  for i, k in enumerate(model)}}}}
    pp = convert_lm_state(state, n_stages=2, virtual=virtual)
    jpp = jax_convert(s1, n_stages=2, virtual=virtual)
    assert len(pp["stages"]) == 2 and pp["step"] == 1
    for tree, moment in ((jpp.params, None), (jpp.opt_state[0].mu, "exp_avg"),
                         (jpp.opt_state[0].nu, "exp_avg_sq")):
        want = split_lm_params(lm_params_from_jax(jax_merge(jax.device_get(tree))), 2, virtual)
        for st, w in zip(pp["stages"], want):
            got = st["model"] if moment is None else {
                k: st["optimizer"]["inner"]["state"][i][moment]
                for i, k in enumerate(st["model"])}
            assert got.keys() == w.keys()
            assert all(torch.equal(got[k], w[k]) for k in w), moment
    for st in pp["stages"]:
        assert st["optimizer"]["inner"]["param_groups"][0]["params"] == list(
            range(len(st["model"])))
    back = convert_lm_state(pp)
    assert list(back["model"]) == list(model) and back["step"] == 1
    assert back["optimizer"]["inner"]["param_groups"] == state["optimizer"]["inner"][
        "param_groups"]
    for i, st in state["optimizer"]["inner"]["state"].items():
        for k, v in st.items():
            assert torch.equal(back["optimizer"]["inner"]["state"][i][k], v)
    with pytest.raises(ValueError, match="not in pipeline layout"):
        convert_lm_state(state)
    with pytest.raises(ValueError, match="not in full layout"):
        convert_lm_state(pp, n_stages=2)


# ------------------------------------------------------------- the checks


def _jax_message(cfg_kw, spec_kw, m, **kw):
    import jax
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.lm_pipeline import make_lm_pipeline_step_fns as jax_factory
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec

    spec = JaxMeshSpec(**spec_kw)
    with pytest.raises(ValueError) as exc:
        jax_factory(JaxLMConfig(**{**TINY, **cfg_kw}), spec, optax.adam(LR),
                    jax.random.key(0), B, T, m, devices=jax.devices()[:spec.num_devices],
                    **kw)
    return str(exc.value)


@pytest.mark.parametrize("cfg_kw,m,kw,match", [
    (dict(n_layers=4), 2, dict(virtual_stages=3), "virtual"),
    (dict(n_layers=8), 1, dict(virtual_stages=2), "groups of pipe"),
    (dict(flash=True, causal=False), 2, {}, "causal"),
    (dict(n_layers=3), 2, {}, "n_layers"),
    ({}, 3, {}, "microbatches"),
    ({}, 2, dict(schedule="zb1"), "schedule"),
    (dict(n_layers=8), 2, dict(schedule="zb", virtual_stages=2), "single-chunk|1f1b"),
    (dict(ce_vocab_chunk=8), 2, dict(schedule="zb"), "ce_vocab_chunk"),
    (dict(ce_vocab_chunk=8), 2, dict(schedule="1f1b"), "ce_vocab_chunk"),
    (dict(attn_impl="sparse"), 2, {}, "attn_impl"),
])
def test_validation_errors_carry_jax_messages(cfg_kw, m, kw, match):
    """Each check of the JAX factory (``tests/test_lm_pipeline.py:422-438,
    620-668`` at ``seq`` 1) raises before any world is needed, with JAX's
    message word for word."""
    want = _jax_message(cfg_kw, dict(pipe=2), m, **kw)
    with pytest.raises(ValueError, match=match) as exc:
        make_lm_pipeline_step_fns(LMConfig(**{**TINY, **cfg_kw}), LMMeshSpec(pipe=2), _adam,
                                  0, B, T, m, device="cpu", **kw)
    assert str(exc.value) == want


@pytest.mark.parametrize("spec_kw,cfg_kw,match", [
    (dict(pipe=2, seq=2), dict(flash=True), "flash=True with attn_impl='dense' requires"),
    (dict(pipe=2, seq=2), dict(attn_impl="ring"), "needs 4 ranks"),
    (dict(pipe=2, model=2), {}, "needs 4 ranks"),
    (dict(pipe=2, expert=2), dict(num_experts=2, expert_top_k=1), "item 11c"),
    (dict(pipe=2), dict(num_experts=2, expert_top_k=1), "item 11c"),
])
def test_other_axes_and_moe_name_their_items(spec_kw, cfg_kw, match):
    """Expert parallelism and MoE raise ``NotImplementedError`` here,
    naming ROADMAP item 11c, from the factory and from
    ``make_lm_step_fns``; the sequence cores and tensor parallelism inside
    the stages are taken (tests/test_torch_lm_pipe_seq.py runs them
    against JAX): flash with the dense core over ``seq`` gets JAX's
    ValueError, and the rest passes every check and asks for its world."""
    spec = LMMeshSpec(**spec_kw)
    cfg = LMConfig(**{**TINY, **cfg_kw})
    if "item" not in match:
        with pytest.raises(ValueError, match=match):
            make_lm_pipeline_step_fns(cfg, spec, _adam, 0, B, T, 2, device="cpu")
        with pytest.raises(ValueError, match=match):
            make_lm_step_fns(cfg, spec, _adam, 0, B, T, device="cpu", num_microbatches=2)
        return
    with pytest.raises(NotImplementedError, match=match):
        make_lm_pipeline_step_fns(cfg, spec, _adam, 0, B, T, 2, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        make_lm_step_fns(cfg, spec, _adam, 0, B, T, device="cpu", num_microbatches=2)


@pytest.mark.parametrize("kw,match", [
    (dict(accum_steps=2), "accum_steps > 1 is the non-pipelined path's microbatching"),
    (dict(zero_sharding=True), "zero_sharding requires the flat"),
])
def test_pipe_refuses_accumulation_and_zero_as_jax(kw, match):
    import jax
    import optax

    from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
    from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
    from ddl_tpu.train.lm_steps import make_lm_step_fns as jax_make_lm_step_fns

    with pytest.raises(ValueError, match=match) as want:
        jax_make_lm_step_fns(JaxLMConfig(**TINY), JaxMeshSpec(pipe=2), optax.adam(LR),
                             jax.random.key(0), B, T, devices=jax.devices()[:2], **kw)
    with pytest.raises(ValueError, match=match) as exc:
        make_lm_step_fns(LMConfig(**TINY), LMMeshSpec(pipe=2), _adam, 0, B, T, device="cpu",
                         **kw)
    assert str(exc.value) == str(want.value)


def test_stage_models_hold_their_layers():
    """``TransformerLM(stage=s)`` holds the embedding on stage 0, the
    chunks' blocks under their global names, the head on the last; the
    stages' keys partition the whole model's."""
    cfg = LMConfig(**TINY)
    whole = list(TransformerLM(cfg).state_dict())
    for stages, virtual, layers in ((2, 1, [[0, 1], [2, 3]]), (2, 2, [[0, 2], [1, 3]]),
                                    (4, 1, [[0], [1], [2], [3]])):
        keys = []
        for s in range(stages):
            model = TransformerLM(cfg, stage=s, stages=stages, virtual=virtual)
            assert model.layers == layers[s]
            assert [b for b in model.blocks()] == [getattr(model, f"block{i}")
                                                   for i in layers[s]]
            assert hasattr(model, "embed") == (s == 0)
            assert hasattr(model, "lm_head") == hasattr(model, "norm_f") == (s == stages - 1)
            keys += list(model.state_dict())
        assert sorted(keys) == sorted(whole)
        assert list(merge_lm_params([dict.fromkeys(keys)])) == whole


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
