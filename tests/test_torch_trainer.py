"""The port's Trainer (ddl_tpu_torch/train/) against the JAX package's:
evaluate and its metric suite, four train steps against make_dp_step_fns,
run_period against the JAX Trainer's, the CSV logs, the config copies, and
the port's device rule."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.config import Config as JaxConfig
from ddl_tpu.config import DataConfig as JaxDataConfig
from ddl_tpu.config import MeshConfig
from ddl_tpu.config import ModelConfig as JaxModelConfig
from ddl_tpu.config import TrainConfig as JaxTrainConfig
from ddl_tpu.data import DataLoader as JaxDataLoader
from ddl_tpu.data import ShardedEpochSampler as JaxSampler
from ddl_tpu.data import SyntheticAptosDataset as JaxSyntheticAptosDataset
from ddl_tpu.data import shard_batch
from ddl_tpu.models.densenet import build_stages, forward_stages
from ddl_tpu.ops import cross_entropy_loss as jax_cross_entropy_loss
from ddl_tpu.ops.pallas_image import pallas_normalize_images
from ddl_tpu.parallel.mesh import MeshSpec, build_mesh
from ddl_tpu.train import Trainer as JaxTrainer
from ddl_tpu.train.state import create_train_state, make_optimizer
from ddl_tpu.train.steps import make_dp_step_fns
from ddl_tpu.utils import masked_classification_eval
from ddl_tpu.utils.csv_logger import MetricLogger as JaxMetricLogger
from ddl_tpu.utils.csv_logger import read_metric_csv
from ddl_tpu_torch.config import Config, DataConfig, MeshConfig as PortMeshConfig
from ddl_tpu_torch.config import ModelConfig, TrainConfig, preset
from ddl_tpu_torch.data import SyntheticAptosDataset
from ddl_tpu_torch.models import DenseNet, from_jax_params
from ddl_tpu_torch.ops import normalize_images
from ddl_tpu_torch.train import Trainer, make_train_step
from ddl_tpu_torch.train import make_optimizer as port_make_optimizer
from ddl_tpu_torch.utils import MetricLogger

MODEL = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16,
             bn_size=2, num_classes=5, dense_block_impl="fused",
             dense_block_fused_blocks=(0, 3), pallas_normalize=True)
IMAGE, EVAL_SET, BATCH = 64, 70, 30  # 30 + 30 + (10 real + 20 sentinel rows)


def _port_cfg(**extra):
    overrides = {f"model.{k}": v for k, v in MODEL.items()}
    overrides.update({"data.image_size": IMAGE, "data.eval_batch_size": BATCH,
                      "data.num_workers": 0, "data.dataset_dir": ""}, **extra)
    return preset("single", **overrides)


def _jax_eval(test_ds):
    """JAX's eval over its own loader: make_dp_step_fns(...).evaluate with the
    Pallas normalize in interpret mode, then masked_classification_eval.
    Returns (metrics, params, batch_stats) with seeded running stats."""
    stages = build_stages(JaxModelConfig(**MODEL, remat=False), num_stages=1)
    mesh = build_mesh(MeshSpec(1, 1))
    tx = make_optimizer(JaxTrainConfig())
    state = create_train_state(stages, tx, jax.random.key(0), IMAGE)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.standard_normal(v.shape) * 0.3 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
        jax.device_get(state.batch_stats),
    )
    state = state.replace(batch_stats=stats)
    fns = make_dp_step_fns(stages, tx, mesh, jnp.float32, normalizer=functools.partial(
        pallas_normalize_images, interpret=True))
    loader = JaxDataLoader(test_ds, BATCH, sampler=JaxSampler(
        len(test_ds), shuffle=False, drop_last=False, pad_mode="sentinel"),
        num_workers=0, drop_last=False, pad_last_batch=True)
    logits, targets = [], []
    for images, labels in loader:
        gi, _ = shard_batch(mesh, images, labels)
        logits.append(np.asarray(fns.evaluate(state, gi)))
        targets.append(labels)
    metrics = masked_classification_eval(np.concatenate(logits), np.concatenate(targets))
    return metrics, jax.device_get(state.params), stats


def test_evaluate_matches_jax_metric_suite():
    """f32 logits agree to 1e-4 (test_torch_densenet), so the argmax-based
    metrics are equal and val_loss agrees to 1e-5."""
    want, params, stats = _jax_eval(JaxSyntheticAptosDataset(EVAL_SET, IMAGE, 5, seed=2))
    trainer = Trainer(_port_cfg(), device="cpu",
                      datasets=(None, SyntheticAptosDataset(EVAL_SET, IMAGE, 5, seed=2)))
    assert len(trainer.test_loader) == 3
    trainer.model.load_state_dict(from_jax_params(params, stats))
    got = trainer.evaluate(0)
    assert got.keys() == want.keys()
    assert got["val_examples"] == EVAL_SET
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)
    for k in want:
        if k != "val_loss":
            assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_trainer_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_port_cfg())


def test_pretrained_overlay_skips_a_mismatched_head(tmp_path):
    """A torchvision-style checkpoint with a 1000-class head: every feature
    weight is taken, the classifier keeps its fresh 5-class values."""
    cfg = _port_cfg(**{"data.synthetic_num_test": 4})
    donor = Trainer(cfg, device="cpu").model.state_dict()
    donor = {k: v + 1 if v.is_floating_point() else v for k, v in donor.items()}
    donor["classifier.weight"] = torch.zeros(1000, donor["classifier.weight"].shape[1])
    donor["classifier.bias"] = torch.zeros(1000)
    path = tmp_path / "imagenet.pth"
    torch.save(donor, path)
    fresh = Trainer(cfg, device="cpu").model.state_dict()
    loaded = Trainer(_port_cfg(**{"data.synthetic_num_test": 4,
                                  "model.pretrained_path": str(path)}),
                     device="cpu").model.state_dict()
    torch.testing.assert_close(loaded["features.conv0.weight"], donor["features.conv0.weight"])
    torch.testing.assert_close(loaded["classifier.weight"], fresh["classifier.weight"])


def test_unported_strategy_is_refused():
    """``dp`` is ported (here a world of one rank), and so are the pipeline
    strategies, refused until ROADMAP item 8 was ported: ``pp`` on a
    (1, 2) mesh validates, a pipe axis that does not match the stages is
    refused by the JAX package's stage-count check, as it is there, and a
    pipelined Trainer needs its world of two ranks."""
    assert preset("single", strategy="dp").strategy == "dp"
    cfg = preset("single", strategy="pp", **{"mesh.pipe": 2, "train.num_microbatches": 2})
    assert (cfg.strategy, cfg.mesh.pipe) == ("pp", 2)
    with pytest.raises(ValueError, match="must equal number of stages"):
        preset("single", strategy="pp", **{"mesh.pipe": 2, "model.split_blocks": ()})
    with pytest.raises(ValueError, match="needs 2 ranks"):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("port,ref", [(ModelConfig, JaxModelConfig), (DataConfig, JaxDataConfig),
                                      (TrainConfig, JaxTrainConfig), (PortMeshConfig, MeshConfig),
                                      (Config, JaxConfig)],
                         ids=["model", "data", "train", "mesh", "config"])
def test_config_copies_match_jax(port, ref):
    """The port's own copies keep every field name and default of the JAX
    package's (TrainConfig's checkpoint, recovery, preemption, profiling
    and pipeline fields, and Config.mesh, included)."""
    def defaults(cls):
        return {f.name: f.default if f.default is not dataclasses.MISSING else f.default_factory()
                for f in dataclasses.fields(cls)}

    assert defaults(port).keys() == defaults(ref).keys()
    if port is Config:
        assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    else:
        assert defaults(port) == defaults(ref)


@pytest.mark.parametrize("name,overrides", [
    ("single", {}), ("dp", {}), ("dp", {"mesh.data": 4, "data.global_batch_size": 60})],
    ids=["single", "dp", "dp-data-4"])
def test_presets_match_jax_field_for_field(name, overrides):
    from ddl_tpu.config import preset as jax_preset
    from ddl_tpu.config import to_dict as jax_to_dict
    from ddl_tpu_torch.config import to_dict

    assert to_dict(preset(name, **overrides)) == jax_to_dict(jax_preset(name, **overrides))


TRAIN_MODEL = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16,
                   bn_size=2, num_classes=5, dense_block_impl="fused",
                   dense_block_fused_blocks=(0, 3))
TRAIN_IMAGE, TRAIN_BATCH, STEPS = 32, 8, 4


def _jax_state(tx):
    stages = build_stages(JaxModelConfig(**TRAIN_MODEL, remat=False), num_stages=1)
    return stages, create_train_state(stages, tx, jax.random.key(0), TRAIN_IMAGE)


def test_train_steps_match_jax_trajectory():
    """Four steps of make_train_step against make_dp_step_fns on a (1, 1)
    mesh, f32, fused blocks, the default (fused) Adam, from the same
    weights and batches.  Losses to rtol 1e-4.  Final parameters: elements
    whose step-1 JAX gradient is above the f32 noise floor of the two
    packages' gradients (1e-4 of the model's largest, test_torch_train)
    are held to 1e-4; the others, whole leaves among them (the stem BN's,
    whose scale the next layer normalises away), get an Adam step of up to
    lr whose sign the noise picks, so they are bounded by 2 * lr * steps.
    Running statistics to 1e-2 (relative): from step 2 on they are batch
    statistics of activations that those noise-driven leaves scale (the
    stem BN scale moves by up to 2 * lr * steps = 8e-3)."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (STEPS, TRAIN_BATCH, TRAIN_IMAGE, TRAIN_IMAGE, 3), dtype=np.uint8)
    labels = rng.integers(0, 5, (STEPS, TRAIN_BATCH)).astype(np.int32)
    tx = make_optimizer(JaxTrainConfig())
    stages, state = _jax_state(tx)
    params0, stats0 = jax.device_get((state.params, state.batch_stats))

    def loss_fn(p):
        x = jnp.asarray(images[0], jnp.float32) / 255.0
        logits, _ = forward_stages(stages, p, stats0, x, train=True)
        return jax_cross_entropy_loss(logits, jnp.asarray(labels[0]))

    grads0 = from_jax_params(jax.grad(loss_fn)(params0), stats0)
    fns = make_dp_step_fns(stages, tx, build_mesh(MeshSpec(1, 1)), jnp.float32)
    want_losses = []
    for t in range(STEPS):
        state, loss, _ = fns.train(state, jnp.asarray(images[t]), jnp.asarray(labels[t]))
        want_losses.append(float(loss))
    want = from_jax_params(*jax.device_get((state.params, state.batch_stats)))

    model = DenseNet(ModelConfig(**TRAIN_MODEL), num_stages=1)
    model.load_state_dict(from_jax_params(params0, stats0))
    step = make_train_step(model.train(), port_make_optimizer(model.parameters(), TrainConfig()),
                           torch.float32, normalize_images)
    got_losses = [step(torch.from_numpy(images[t]), torch.from_numpy(labels[t]))[0].item()
                  for t in range(STEPS)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    got = model.state_dict()
    lr = TrainConfig().learning_rate
    names = [k for k, _ in model.named_parameters()]
    floor = 1e-4 * max(np.abs(grads0[k].numpy()).max() for k in names)
    for k in names:
        live = np.abs(grads0[k].numpy()) > floor
        diff = np.abs(got[k].numpy() - want[k].numpy())
        assert diff[live].max(initial=0) <= 1e-4, k
        assert diff.max() <= 2 * lr * STEPS, k
    for k in (k for k in want if "running" in k):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-2, atol=1e-4,
                                   err_msg=k)


def _train_cfgs(tmp_path):
    """The same run for both packages: tiny fused model, f32, 24 training
    and 16 eval images of 32 px, batch 8, logs and checkpoints under
    tmp_path (the port's in a directory of its own)."""
    data = dict(dataset_dir="", synthetic_num_train=24, synthetic_num_test=16,
                image_size=TRAIN_IMAGE, global_batch_size=TRAIN_BATCH,
                eval_batch_size=TRAIN_BATCH, num_workers=0)
    jax_cfg = JaxConfig(
        strategy="single", mesh=MeshConfig(1, 1),
        model=JaxModelConfig(**TRAIN_MODEL, remat=False), data=JaxDataConfig(**data),
        train=JaxTrainConfig(max_epochs=1, log_dir=str(tmp_path / "jax_logs"),
                             checkpoint_dir=str(tmp_path / "ckpt"), auto_resume=False,
                             save_best_qwk=False),
    ).validate()
    port_cfg = preset("single", **{f"model.{k}": v for k, v in TRAIN_MODEL.items()},
                      **{f"data.{k}": v for k, v in data.items()},
                      **{"train.log_dir": str(tmp_path / "logs"), "train.max_epochs": 1,
                         "train.checkpoint_dir": str(tmp_path / "port_ckpt")})
    return jax_cfg, port_cfg


def _synthetic(n_train, n_test, jax_side):
    cls = JaxSyntheticAptosDataset if jax_side else SyntheticAptosDataset
    return cls(n_train, TRAIN_IMAGE, 5, seed=1), cls(n_test, TRAIN_IMAGE, 5, seed=2)


def test_run_period_matches_jax_trainer(tmp_path):
    """Trainer.run_period(0) of both packages on the same synthetic set,
    sampler seed and carried-over weights: same step count, mean loss to
    rtol 1e-4 (the trajectory test's agreement), train accuracy equal (the
    predictions are argmaxes of logits that agree to 1e-4)."""
    jax_cfg, port_cfg = _train_cfgs(tmp_path)
    jt = JaxTrainer(jax_cfg, datasets=_synthetic(24, 16, True))
    pt = Trainer(port_cfg, device="cpu", datasets=_synthetic(24, 16, False))
    pt.model.load_state_dict(from_jax_params(*jax.device_get(
        (jt.state.params, jt.state.batch_stats))))
    want, want_steps = jt.run_period(0)
    got, got_steps = pt.run_period(0)
    assert got_steps == want_steps == 3
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert got["train_accuracy"] == want["train_accuracy"]


def test_train_logs_the_jax_csv_files(tmp_path):
    """train(1) writes one CSV per metric in the JAX package's layout: the
    same files as its Trainer (minus the JAX-only obs streams), rows of
    [timestamp, job_id, rank, rank, start job, epoch, value]."""
    _, cfg = _train_cfgs(tmp_path)
    trainer = Trainer(cfg, device="cpu", datasets=_synthetic(16, 8, False))
    trainer.train()
    assert trainer.periods_run == 1
    job_dir = tmp_path / "logs" / "by_job_id" / trainer.job_id
    names = {p.stem for p in job_dir.glob("*.csv")}
    assert {"loss", "train_accuracy", "epoch_time", "steps_per_sec", "val_loss",
            "val_accuracy", "qwk", "macro_f1", "val_examples"} <= names
    rows = read_metric_csv(job_dir / "loss.csv")
    assert [(r["job_id"], r["global_rank"], r["epoch"]) for r in rows] == [(trainer.job_id, 0, 0)]
    assert np.isfinite(rows[0]["value"])
    assert read_metric_csv(job_dir / "val_examples.csv")[0]["value"] == 8


def test_logger_writes_what_the_jax_logger_writes(tmp_path):
    metrics = {"loss": 1.25, "qwk": 0.5}
    for cls, sub in ((JaxMetricLogger, "jax"), (MetricLogger, "port")):
        logger = cls(tmp_path / sub, "job", global_rank=1, local_rank=2, model_start_job_id="j0")
        logger.log_many(metrics, 3)
        logger.log("epoch_time", 4.5, 3)
        logger.log_gradient_stats({"w": np.arange(6.0) - 2}, step=7)
    for rel in ("by_job_id/job/loss.csv", "by_job_id/job/qwk.csv",
                "by_job_id/job/epoch_time.csv", "gradient.csv"):
        jax_rows = [r.split(",")[1:] for r in (tmp_path / "jax" / rel).read_text().splitlines()]
        port_rows = [r.split(",")[1:] for r in (tmp_path / "port" / rel).read_text().splitlines()]
        assert port_rows == jax_rows, rel


def test_train_halts_on_a_nonfinite_loss(tmp_path, monkeypatch):
    _, cfg = _train_cfgs(tmp_path)
    trainer = Trainer(cfg, device="cpu", datasets=_synthetic(16, 8, False))
    monkeypatch.setattr(trainer, "run_period",
                        lambda epoch, guard=None: ({"loss": float("nan")}, 1))
    with pytest.raises(RuntimeError, match="Non-finite training loss"):
        trainer.train(1)
    assert trainer.periods_run == 0
