"""The port's own copies of the data pipeline and metrics
(ddl_tpu_torch/data/, ddl_tpu_torch/utils/metrics.py) against the JAX
package's: same images, same index order, same batches, same metrics."""

import numpy as np
import pytest
import torch
from PIL import Image

from ddl_tpu.config import DataConfig as JaxDataConfig
from ddl_tpu.data import AptosImageDataset as JaxAptosImageDataset
from ddl_tpu.data import DataLoader as JaxDataLoader
from ddl_tpu.data import ShardedEpochSampler as JaxSampler
from ddl_tpu.data import SyntheticAptosDataset as JaxSyntheticAptosDataset
from ddl_tpu.data import build_datasets as jax_build_datasets
from ddl_tpu.utils import masked_classification_eval as jax_masked_classification_eval
from ddl_tpu_torch.config import DataConfig
from ddl_tpu_torch.data import (
    AptosImageDataset,
    DataLoader,
    ShardedEpochSampler,
    SyntheticAptosDataset,
    build_datasets,
    to_device,
)
from ddl_tpu_torch.utils import masked_classification_eval


def test_synthetic_images_bit_identical():
    port, ref = SyntheticAptosDataset(9, 32, 5, seed=3), JaxSyntheticAptosDataset(9, 32, 5, seed=3)
    np.testing.assert_array_equal(port.labels, ref.labels)
    for i in (0, 4, 8):
        img, label = port[i]
        want_img, want_label = ref[i]
        assert img.dtype == np.uint8 and label == want_label
        np.testing.assert_array_equal(img, want_img)


def test_build_datasets_falls_back_to_the_same_synthetic_sets():
    kw = dict(dataset_dir="", synthetic_num_train=5, synthetic_num_test=4, image_size=16)
    for port, ref in zip(build_datasets(DataConfig(**kw)), jax_build_datasets(JaxDataConfig(**kw))):
        assert len(port) == len(ref)
        np.testing.assert_array_equal(port[len(port) - 1][0], ref[len(ref) - 1][0])


def test_aptos_csv_dataset_reads_like_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "imgs").mkdir()
    rows = ["id_code,diagnosis"]
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
            tmp_path / "imgs" / f"im{i}.png")
        rows.append(f"im{i},{i % 5}")
    (tmp_path / "test.csv").write_text("\n".join(rows) + "\n")
    args = (tmp_path / "test.csv", tmp_path / "imgs", "id_code")
    port, ref = AptosImageDataset(*args), JaxAptosImageDataset(*args)
    assert len(port) == len(ref) == 3
    for i in range(3):
        np.testing.assert_array_equal(port[i][0], ref[i][0])
        assert port[i][1] == ref[i][1]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last,pad_mode", [(True, "wrap"), (False, "wrap"),
                                                (False, "sentinel")])
def test_sampler_indices_identical(shuffle, drop_last, pad_mode):
    kw = dict(num_examples=11, num_shards=3, shard_rank=1, shuffle=shuffle,
              drop_last=drop_last, seed=5, pad_mode=pad_mode)
    port, ref = ShardedEpochSampler(**kw), JaxSampler(**kw)
    port.set_epoch(2)
    ref.set_epoch(2)
    assert len(port) == len(ref)
    np.testing.assert_array_equal(port.indices(), ref.indices())


def test_eval_loader_batches_identical_with_sentinel_padding():
    port_ds, ref_ds = SyntheticAptosDataset(7, 16, 5, seed=2), JaxSyntheticAptosDataset(7, 16, 5, seed=2)
    kw = dict(shuffle=False, drop_last=False, pad_mode="sentinel")
    port = DataLoader(port_ds, 3, sampler=ShardedEpochSampler(7, **kw), num_workers=2,
                      drop_last=False, pad_last_batch=True)
    ref = JaxDataLoader(ref_ds, 3, sampler=JaxSampler(7, **kw), num_workers=0,
                        drop_last=False, pad_last_batch=True)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == len(port) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.uint8 and gl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(got[-1][1][1:], [-1, -1])
    assert not got[-1][0][1:].any()


def test_to_device_keeps_uint8_on_the_wire():
    images = np.zeros((2, 4, 4, 3), np.uint8)
    gi, gl = to_device(images, np.array([1, -1], np.int32), "cpu")
    assert gi.dtype == torch.uint8 and gl.dtype == torch.int32
    assert gi.shape == (2, 4, 4, 3)


def test_masked_metrics_identical():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(40, 5)).astype(np.float32)
    targets = rng.integers(0, 5, 40)
    targets[-7:] = -1
    assert masked_classification_eval(logits, targets) == jax_masked_classification_eval(logits, targets)
