"""Datasets (own copy of ``ddl_tpu/data/dataset.py``): APTOS-2019 and a
synthetic stand-in.

Both return numpy HWC uint8 images; normalisation happens on the device.
``SyntheticAptosDataset`` gives bit-identical images to the JAX package's
for the same seed, so the two packages can be compared on the same data.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["AptosImageDataset", "SyntheticAptosDataset", "build_datasets"]


class AptosImageDataset:
    """CSV-metadata PNG dataset: a ``(filename, diagnosis)`` CSV beside a
    directory of ``<filename>.png`` images."""

    def __init__(
        self,
        csv_file: str | os.PathLike,
        root_dir: str | os.PathLike,
        filename_col: str,
        label_col: str = "diagnosis",
    ) -> None:
        self.root_dir = Path(root_dir)
        self.filenames: list[str] = []
        self.labels: list[int] = []
        with open(csv_file, newline="") as f:
            reader = csv.DictReader(f)
            if filename_col not in (reader.fieldnames or []):
                raise ValueError(
                    f"column {filename_col!r} not in {csv_file} "
                    f"(have {reader.fieldnames})"
                )
            for row in reader:
                self.filenames.append(str(row[filename_col]))
                self.labels.append(int(row[label_col]))

    def __len__(self) -> int:
        return len(self.filenames)

    def image_path(self, idx: int) -> Path:
        return self.root_dir / f"{self.filenames[idx]}.png"

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        from PIL import Image

        with Image.open(self.image_path(idx)) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
        return arr, self.labels[idx]


class SyntheticAptosDataset:
    """Deterministic learnable synthetic data shaped like preprocessed APTOS:
    class c renders a bright Gaussian blob at a class-dependent position
    over a noisy background."""

    def __init__(
        self,
        num_examples: int,
        image_size: int = 224,
        num_classes: int = 5,
        seed: int = 0,
        noise: float = 0.15,
    ) -> None:
        self.num_examples = num_examples
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, num_classes, size=num_examples).astype(np.int64)
        angles = 2 * np.pi * np.arange(num_classes) / num_classes
        r = image_size * 0.25
        cx = image_size / 2 + r * np.cos(angles)
        cy = image_size / 2 + r * np.sin(angles)
        self._centers = np.stack([cy, cx], axis=1)
        yy, xx = np.mgrid[0:image_size, 0:image_size]
        self._grid = (yy, xx)

    def __len__(self) -> int:
        return self.num_examples

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        label = int(self.labels[idx])
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        cy, cx = self._centers[label]
        yy, xx = self._grid
        sigma = self.image_size * 0.08
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)))
        img = 0.3 + 0.6 * blob[..., None] + self.noise * rng.standard_normal(
            (self.image_size, self.image_size, 3)
        )
        img = np.clip(img, 0.0, 1.0)
        return (img * 255).astype(np.uint8), label


def build_datasets(data_cfg):
    """(train, test): real APTOS if the dataset dir holds the train CSV,
    else the synthetic set (seeds 1 and 2, as in the JAX package)."""
    d = Path(data_cfg.dataset_dir) if data_cfg.dataset_dir else None
    if d and (d / data_cfg.train_csv).exists():
        train = AptosImageDataset(
            d / data_cfg.train_csv,
            d / data_cfg.train_images,
            filename_col=data_cfg.train_filename_col,
            label_col=data_cfg.label_col,
        )
        test = AptosImageDataset(
            d / data_cfg.test_csv,
            d / data_cfg.test_images,
            filename_col=data_cfg.test_filename_col,
            label_col=data_cfg.label_col,
        )
        return train, test
    train = SyntheticAptosDataset(
        data_cfg.synthetic_num_train, data_cfg.image_size, data_cfg.num_classes, seed=1
    )
    test = SyntheticAptosDataset(
        data_cfg.synthetic_num_test, data_cfg.image_size, data_cfg.num_classes, seed=2
    )
    return train, test
