"""Carry weights between the JAX package's stage trees and this port's
``state_dict`` (counterpart of ``ddl_tpu/models/convert.py:31-92``).

The JAX parameters are a tuple with one nested dict per stage, and so are
the batch statistics; here they are nested dicts of numpy arrays (what
``jax.device_get`` returns), so this module needs no JAX.  The mapping is
mechanical because both sides use torchvision's module names:

* conv kernels HWIO <-> OIHW, ``Dense`` kernels (in, out) <-> (out, in);
* BatchNorm ``scale``/``bias`` params <-> ``weight``/``bias``, and
  ``mean``/``var`` batch stats <-> ``running_mean``/``running_var``
  (``num_batches_tracked``, which the JAX tree lacks, is 0).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ddl_tpu_torch.models.densenet import StageSpec

__all__ = ["from_jax_params", "to_jax_params"]

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
_STATS_BACK = {"running_mean": "mean", "running_var": "var"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path: tuple) -> str:
    *modules, leaf = path
    if modules and modules[0] == "classifier":
        return ".".join(modules + [_LEAF[leaf]])
    return ".".join(["features", *modules, _LEAF[leaf]])


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # conv HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:  # dense (in, out) -> (out, in)
        return arr.T
    return arr


def from_jax_params(params: Sequence[Mapping], batch_stats: Sequence[Mapping]) -> dict:
    """JAX stage trees -> a ``state_dict`` for ``models.densenet.DenseNet``."""
    sd = {}
    for tree in (*params, *batch_stats):
        for path, value in _flatten(tree):
            arr = _to_torch_layout(np.asarray(value, dtype=np.float32))
            sd[_torch_key(path)] = torch.tensor(arr)
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.removesuffix("running_mean") + "num_batches_tracked"] = torch.tensor(0)
    return sd


def _stage_of(key: str, stages: Sequence[StageSpec]) -> int:
    parts = key.split(".")
    if parts[0] == "classifier" or parts[1] == "norm5":
        return len(stages) - 1
    for name in ("denseblock", "transition"):
        if parts[1].startswith(name):
            block = int(parts[1][len(name):]) - 1
            return next(i for i, s in enumerate(stages)
                        if s.start_block <= block < s.end_block)
    return 0  # stem


def to_jax_params(state_dict: Mapping[str, torch.Tensor],
                  stages: Sequence[StageSpec]) -> tuple[tuple, tuple]:
    """A port ``state_dict`` -> (params, batch_stats) stage tuples of nested
    numpy dicts, the inverse of ``from_jax_params``."""
    params = tuple({} for _ in stages)
    stats = tuple({} for _ in stages)
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        *modules, leaf = key.split(".")
        if modules[0] == "features":
            modules = modules[1:]
        arr = value.detach().cpu().numpy()
        if leaf in _STATS_BACK:
            tree, name = stats, _STATS_BACK[leaf]
        else:
            tree = params
            name = leaf if leaf == "bias" else ("kernel" if arr.ndim > 1 else "scale")
            if arr.ndim == 4:  # OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
        node = tree[_stage_of(key, stages)]
        for m in modules:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return params, stats
