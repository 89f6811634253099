"""The port's Trainer.evaluate (ddl_tpu_torch/train/) against the JAX
package's eval step and metric suite on the same weights and batches, and
the port's device rule."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.config import DataConfig as JaxDataConfig
from ddl_tpu.config import ModelConfig as JaxModelConfig
from ddl_tpu.config import TrainConfig as JaxTrainConfig
from ddl_tpu.data import DataLoader as JaxDataLoader
from ddl_tpu.data import ShardedEpochSampler as JaxSampler
from ddl_tpu.data import SyntheticAptosDataset as JaxSyntheticAptosDataset
from ddl_tpu.data import shard_batch
from ddl_tpu.models.densenet import build_stages
from ddl_tpu.ops.pallas_image import pallas_normalize_images
from ddl_tpu.parallel.mesh import MeshSpec, build_mesh
from ddl_tpu.train.state import create_train_state, make_optimizer
from ddl_tpu.train.steps import make_dp_step_fns
from ddl_tpu.utils import masked_classification_eval
from ddl_tpu_torch.config import DataConfig, ModelConfig, preset
from ddl_tpu_torch.data import SyntheticAptosDataset
from ddl_tpu_torch.models import from_jax_params
from ddl_tpu_torch.train import Trainer

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
    with pytest.raises(ValueError, match="not ported"):
        preset("single", strategy="dp")


@pytest.mark.parametrize("port,ref", [(ModelConfig, JaxModelConfig), (DataConfig, JaxDataConfig)],
                         ids=["model", "data"])
def test_config_copies_match_jax(port, ref):
    """The port's own copies keep every field name and default."""
    def defaults(cls):
        return {f.name: f.default if f.default is not dataclasses.MISSING else f.default_factory()
                for f in dataclasses.fields(cls)}

    assert defaults(port) == defaults(ref)
