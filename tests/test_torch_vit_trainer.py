"""The port's ViT trainer (ddl_tpu_torch/train/vit_trainer.py) and its
entry point (ddl_tpu_torch/examples/train_vit.py).

``ViTTrainer.run_period`` and ``evaluate_period`` against the JAX
``ViTTrainer`` on one CPU device, from the JAX trainer's initial weights
(``models/convert.vit_params_from_jax``) and the same synthetic APTOS-shape
sets: the epoch's loss 1e-5 relative, the parameters after it 1e-4 of the
largest, the masked eval suite (val_loss 1e-4, accuracy and QWK equal).
Then exact resume: a run preempted mid-epoch (``preempt@step``) and
relaunched ends bit-equal to the uninterrupted run.  Last, the example's
command line: a two-rank gloo pipeline under zb writes the per-stage
snapshot layout, which the one-device layout's run refuses naming both,
and each rank's ``pipe_schedule`` event, the JAX model's numbers."""

import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ddl_tpu.config import DataConfig as JaxDataConfig
from ddl_tpu.models.vit import ViTConfig as JaxViTConfig
from ddl_tpu.obs.schedule_model import schedule_summary as jax_schedule_summary
from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
from ddl_tpu.train.state import build_optimizer
from ddl_tpu.train.vit_trainer import ViTRunConfig as JaxRunConfig
from ddl_tpu.train.vit_trainer import ViTTrainer as JaxViTTrainer
from ddl_tpu.utils import faultinject as jax_faultinject
from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.config import DataConfig
from ddl_tpu_torch.examples import train_vit
from ddl_tpu_torch.models.convert import vit_params_from_jax
from ddl_tpu_torch.models.vit import ViTConfig
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.state import Optimizer
from ddl_tpu_torch.train.vit_trainer import ViTRunConfig, ViTTrainer
from ddl_tpu_torch.utils import faultinject

TINY = dict(image_size=32, patch_size=8, num_classes=5, d_model=64, n_layers=2, n_heads=4,
            head_dim=16, d_ff=128, compute_dtype="float32")
DATA = dict(image_size=32, global_batch_size=8, eval_batch_size=8, synthetic_num_train=24,
            synthetic_num_test=20, num_workers=0)
RUN = dict(batch=8, epochs=2, log_dir=None)
LR, PREEMPT_STEP = 1e-3, 4  # 3 steps an epoch: the second batch of epoch 1


@pytest.fixture(autouse=True)
def _clean_injectors():
    faultinject.deactivate()
    jax_faultinject.deactivate()
    yield
    faultinject.deactivate()
    jax_faultinject.deactivate()


def _tx(params):
    """The example's optimizer: AdamW, weight decay 0.05, clip 1.0."""
    return Optimizer(params, LR, weight_decay=0.05, grad_clip_norm=1.0)


def _jax_trainer() -> JaxViTTrainer:
    return JaxViTTrainer(JaxViTConfig(**TINY), JaxMeshSpec(),
                         build_optimizer(LR, weight_decay=0.05, grad_clip_norm=1.0),
                         JaxRunConfig(**RUN, checkpoint_dir=None), data=JaxDataConfig(**DATA),
                         rng=jax.random.key(0))


@functools.cache
def _jax_run():
    """The JAX trainer's initial weights, epoch 0's train and eval metrics
    and its weights after the epoch, as port ``state_dict``s."""
    t = _jax_trainer()

    def params():
        return vit_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jax.device_get(t.state.params)))

    p0 = params()
    train, steps = t.run_period(0)
    return p0, train, steps, t.evaluate_period(0), params()


def _port_trainer(root=None, job="vit", **run_kw) -> ViTTrainer:
    """A port trainer; a fresh start takes the JAX trainer's initial
    weights, a resumed one keeps what it restored."""
    run = ViTRunConfig(**{**RUN, "checkpoint_dir": root and f"{root}/ckpt", "job_id": job,
                          **run_kw})
    t = ViTTrainer(ViTConfig(**TINY), LMMeshSpec(), _tx, run, data=DataConfig(**DATA),
                   device="cpu")
    if t.state.step == 0:
        t.state.model.load_state_dict(_jax_run()[0])
    return t


def test_run_and_evaluate_period_match_the_jax_trainer():
    _, want_train, want_steps, want_eval, want_params = _jax_run()
    t = _port_trainer()
    train, steps = t.run_period(0)
    assert steps == want_steps == 3
    np.testing.assert_allclose(train["loss"], want_train["loss"], rtol=1e-5)
    got = t.state.model.state_dict()
    scale = max(v.abs().max().item() for v in want_params.values())
    assert max((got[k] - v).abs().max().item() for k, v in want_params.items()) <= 1e-4 * scale
    ev = t.evaluate_period(0)
    assert ev["val_examples"] == want_eval["val_examples"] == 20
    np.testing.assert_allclose(ev["val_loss"], want_eval["val_loss"], rtol=1e-4)
    for key in ("val_accuracy", "qwk"):
        assert ev[key] == want_eval[key], key


def test_preempted_run_resumes_bit_equal_to_the_whole_run(tmp_path):
    whole = _port_trainer(tmp_path, job="whole")
    whole.train()
    faultinject.activate(f"preempt@step:{PREEMPT_STEP}")
    first = _port_trainer(tmp_path, job="cut")
    first.train()
    faultinject.deactivate()
    assert first.preempted
    assert ckpt.read_cursor(tmp_path / "ckpt", "cut", 1) == {"period": 1, "offset": 2}
    second = _port_trainer(tmp_path, job="cut")
    assert (second.periods_run, second._resume_offset, second.state.step) == (1, 2, 5)
    second.train()
    assert second.state.step == whole.state.step == 6
    want = whole.stage_state()
    got = second.stage_state()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, st in want["optimizer"]["inner"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got["optimizer"]["inner"]["state"][i][name], st[name])
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 6


def test_example_pipeline_snapshot_is_refused_by_a_flat_run(tmp_path, monkeypatch):
    """``--cpu-devices 2 --pipe 2 --pipeline-schedule zb``: two gloo ranks,
    one epoch, the best-QWK snapshot in the per-stage layout (each stage's
    tensors); the one-device run that resumes it fails naming both
    layouts."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(Path(__file__).resolve().parents[1]))
    common = ["--image-size", "32", "--patch", "8", "--d-model", "64", "--layers", "2",
              "--batch", "8", "--num-train", "24", "--num-test", "20", "--job-id", "ex",
              "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs")]
    assert train_vit.main(["--cpu-devices", "2", "--pipe", "2", "--pipeline-schedule", "zb",
                           "--epochs", "1", *common]) is None
    state, _ = ckpt.load_snapshot(tmp_path / "ckpt", "ex", 0)
    stages = state["stages"]
    assert len(stages) == 2 and stages[0]["step"] == stages[1]["step"] == 3
    assert "patch_embed.weight" in stages[0]["model"] and "block1.mlp.wo.kernel" in (
        stages[1]["model"]) and "head.kernel" in stages[1]["model"]
    job_logs = tmp_path / "logs" / "by_job_id" / "ex"
    assert next(job_logs.rglob("loss*.csv"), None) is not None
    want = jax_schedule_summary("zb", 2, 2)
    for host in range(2):
        events = [json.loads(line) for line in
                  (job_logs / f"events-h{host:03d}.jsonl").read_text().splitlines()]
        (sched,) = [e for e in events if e["kind"] == "pipe_schedule"]
        assert (sched["schedule"], sched["pipe"], sched["microbatches"], sched["virtual"]) == (
            "zb", 2, 2, 1)
        for key in ("makespan", "idle_units", "bubble_fraction", "per_stage"):
            assert sched[key] == want[key], key
    with pytest.raises(ValueError, match="the pipelined layout of 2 stages; this run needs "
                                         "the one-device layout"):
        train_vit.main(["--device", "cpu", "--epochs", "2", "--resume-epoch", "0", *common])
