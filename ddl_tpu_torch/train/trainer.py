"""The CNN trainer's model/data set-up and eval loop (counterpart of
``ddl_tpu/train/trainer.py:64-189, 387-401``).

``Trainer(cfg).evaluate(epoch)`` is the port's serving path for the
flagship model: uint8 batch -> normalize -> DenseNet in eval mode ->
logits -> the masked metric suite (val_loss, accuracy, QWK, F1, ...).
Eval is deterministic and full-coverage: an ordered sampler with no
dropped tail, the last batch padded to full size with label -1 rows that
the metrics mask out, so every test sample counts exactly once.

The training loop (optimizer, train step, checkpoints, the shared epoch
loop) is the next slice of the port and is not here.
"""

from __future__ import annotations

import numpy as np
import torch

from ddl_tpu_torch.config import Config
from ddl_tpu_torch.data import DataLoader, ShardedEpochSampler, build_datasets, to_device
from ddl_tpu_torch.models import DenseNet, init_weights
from ddl_tpu_torch.ops import get_normalizer
from ddl_tpu_torch.train.steps import make_eval_step
from ddl_tpu_torch.utils import masked_classification_eval

__all__ = ["Trainer", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises (the
    port never drops to the CPU unless the caller asks for it)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def load_pretrained(model: DenseNet, path: str) -> list[str]:
    """Overlay a torchvision DenseNet ``state_dict`` (.pth) onto ``model``;
    returns the keys left at their fresh values because their shapes
    differ (the 1000-class ImageNet classifier vs a 5-class head) or the
    file lacks them."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    own = model.state_dict()
    keep = {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(keep, strict=False)
    return sorted(k for k in own if k not in keep)


class Trainer:
    def __init__(self, cfg: Config, device=None, datasets=None) -> None:
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.model.compute_dtype)
        model = DenseNet(cfg.model, num_stages=1)
        init_weights(model, cfg.train.seed)
        if cfg.model.pretrained_path:
            skipped = load_pretrained(model, cfg.model.pretrained_path)
            if skipped:
                print(f"[ddl_tpu_torch] pretrained overlay skipped keys: {skipped}")
        self.model = model.to(self.device).eval()
        self.eval_step = make_eval_step(
            self.model, self.compute_dtype,
            normalizer=get_normalizer(cfg.model.pallas_normalize),
        )
        _, test_ds = datasets if datasets is not None else build_datasets(cfg.data)
        if len(test_ds) == 0:
            raise ValueError("empty eval set")
        self.test_loader = DataLoader(
            test_ds,
            cfg.data.eval_batch_size,
            sampler=ShardedEpochSampler(
                len(test_ds), shuffle=False, drop_last=False,
                pad_mode="sentinel", seed=cfg.train.seed + 1,
            ),
            num_workers=cfg.data.num_workers,
            drop_last=False,
            pad_last_batch=True,
        )

    def evaluate(self, epoch: int) -> dict:
        """Eval loop -> metric dict, over every test sample exactly once.
        Logits stay on the device until the loop ends; one copy to the
        host then."""
        self.test_loader.set_epoch(epoch)
        logits, targets = [], []
        for images, labels in self.test_loader:
            gi, _ = to_device(images, labels, self.device)
            logits.append(self.eval_step(gi))
            targets.append(labels)
        all_logits = torch.cat(logits).cpu().numpy()
        return masked_classification_eval(all_logits, np.concatenate(targets))
