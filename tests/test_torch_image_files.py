"""The image-file data path end to end on the CPU (chip_smoke.py phase
10 (c) against (d) at a small size): a DenseNet Trainer over an
APTOS-layout tree of PNG files, decoded by the native decoder, trains
bit for bit as the same Trainer over the in-memory synthetic set the files
were written from; and the JAX package's datasets read the same images
and labels from the files as the port's decoder."""

import numpy as np
import pytest
import torch

import chip_smoke
from ddl_tpu.config import preset as jax_preset
from ddl_tpu.data import build_datasets as jax_build_datasets
from ddl_tpu_torch import native
from ddl_tpu_torch.config import preset
from ddl_tpu_torch.data import SyntheticAptosDataset, build_datasets
from ddl_tpu_torch.train import Trainer

N_TRAIN, N_TEST, SIZE = 24, 10, 32
TINY = {"model.growth_rate": "4", "model.block_config": "[2,2,2,2]",
        "model.num_init_features": "8", "model.bn_size": "2", "data.image_size": str(SIZE),
        "data.global_batch_size": "8", "data.eval_batch_size": "4",
        "data.synthetic_num_train": str(N_TRAIN), "data.synthetic_num_test": str(N_TEST),
        "train.max_epochs": "2", "train.auto_resume": "false", "data.num_workers": "2"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("aptos")
    chip_smoke.write_aptos_tree(root, SyntheticAptosDataset(N_TRAIN, SIZE, 5, seed=1),
                                SyntheticAptosDataset(N_TEST, SIZE, 5, seed=2))
    return root


def _run(tmp_path, name, dataset_dir):
    cfg = preset("single", **TINY, **{"data.dataset_dir": str(dataset_dir),
                                      "train.log_dir": str(tmp_path / name / "logs"),
                                      "train.checkpoint_dir": str(tmp_path / name / "ckpt")})
    native.batches.update(native=0, pil=0)
    t = Trainer(cfg, device="cpu")
    losses = []
    run_period = t.run_period

    def spy(epoch, guard=None):
        metrics, steps = run_period(epoch, guard)
        losses.append(metrics["loss"])
        return metrics, steps

    t.run_period = spy
    t.train()
    return t, losses, dict(native.batches)


def test_png_tree_trains_bit_equal_to_the_in_memory_set(tree, tmp_path):
    files, file_losses, file_batches = _run(tmp_path, "files", tree)
    memory, memory_losses, memory_batches = _run(tmp_path, "memory", "")
    # 3 train batches and 3 eval batches (the last padded) an epoch
    assert file_batches == {"native": 12, "pil": 0}
    assert memory_batches == {"native": 0, "pil": 0}
    assert file_losses == memory_losses and all(np.isfinite(file_losses))
    got = chip_smoke.flat_state(files.snapshot_state())
    want = chip_smoke.flat_state(memory.snapshot_state())
    assert got.keys() == want.keys() and len(want) > 100
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_jax_and_port_read_the_same_files(tree):
    """``build_datasets`` of both packages on the tree: the same images
    (the JAX loader's PIL/native path and the port's decoder) and labels."""
    jax_train, jax_test = jax_build_datasets(jax_preset("single", **{
        "data.dataset_dir": str(tree)}).data)
    port_train, port_test = build_datasets(preset("single", **{
        "data.dataset_dir": str(tree)}).data)
    for j, p in ((jax_train, port_train), (jax_test, port_test)):
        assert list(j.labels) == list(p.labels)
        paths = [p.image_path(i) for i in range(len(p))]
        np.testing.assert_array_equal(native.load_batch(paths, SIZE, SIZE),
                                      np.stack([j[i][0] for i in range(len(j))]))
