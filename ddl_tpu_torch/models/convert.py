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

The transformer LM (``lm_params_from_jax``/``lm_params_to_jax``) keeps
Flax's names and layouts, so its mapping is the tree path alone; the ViT
(``vit_params_from_jax``/``vit_params_to_jax``) too, but for its patchify
convolution, whose kernel is HWIO in JAX and OIHW here.

Tensor parallelism (``shard_lm_state``/``gather_lm_state`` and the ViT's
``shard_vit_state``/``gather_vit_state``): a snapshot state in the
one-device layout (``{"model": state_dict, "optimizer":
Optimizer.state_dict(), ...}``) cut into one ``model`` rank's part, and
the ranks' parts joined back, driven by the family's rule table
(``parallel/rules.lm_rules``/``vit_rules``): a dimension a leaf's spec
shards over ``model`` splits into ``ceil(n/model)``-long parts, the last
padded with zeros (an odd vocabulary), and a join strips the padding.
Adam's per-parameter moments follow their parameter (they are indexed in
the model's key order, which is its parameters' order).  The pipe split
(``parallel/lm_pipeline.convert_lm_state``) goes by key and composes: cut
over ``model`` first, then into stages; JAX's numpy parameters reach any
rank's part as ``lm_params_from_jax``, then the cut.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ddl_tpu_torch.models.densenet import StageSpec

__all__ = [
    "from_jax_params",
    "gather_lm_state",
    "gather_state",
    "gather_vit_state",
    "from_jax_train_state",
    "jax_param_names",
    "lm_params_from_jax",
    "lm_params_to_jax",
    "shard_lm_state",
    "shard_state",
    "shard_vit_state",
    "to_jax_params",
    "vit_params_from_jax",
    "vit_params_to_jax",
]

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


def _jax_path(key: str, ndim: int) -> tuple[str, ...]:
    """A port parameter or buffer key -> its path in its JAX stage tree."""
    *modules, leaf = key.split(".")
    if modules[0] == "features":
        modules = modules[1:]
    if leaf in _STATS_BACK:
        return (*modules, _STATS_BACK[leaf])
    return (*modules, leaf if leaf == "bias" else ("kernel" if ndim > 1 else "scale"))


def jax_param_names(named_params, stages: Sequence[StageSpec]) -> dict[str, str]:
    """Port parameter key -> the JAX package's name for it in per-parameter
    logs (``stage<i>/conv0/kernel``, as ``make_grad_stats_fn`` names its
    gradients), in that function's order: stage by stage, then the
    flattening order of the stage tree (its paths sorted)."""
    paths = sorted((_stage_of(key, stages), _jax_path(key, p.ndim), key)
                   for key, p in named_params)
    return {key: "/".join((f"stage{stage}", *path)) for stage, path, key in paths}


def to_jax_params(state_dict: Mapping[str, torch.Tensor],
                  stages: Sequence[StageSpec]) -> tuple[tuple, tuple]:
    """A port ``state_dict`` -> (params, batch_stats) stage tuples of nested
    numpy dicts, the inverse of ``from_jax_params``."""
    params = tuple({} for _ in stages)
    stats = tuple({} for _ in stages)
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        arr = value.detach().cpu().numpy()
        *modules, name = _jax_path(key, arr.ndim)
        if key.split(".")[-1] in _STATS_BACK:
            tree = stats
        else:
            tree = params
            if arr.ndim == 4:  # OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
        node = tree[_stage_of(key, stages)]
        for m in modules:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return params, stats


def _adam_node(opt_state):
    """The node of an optax optimizer state that holds Adam's moments."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for node in opt_state:
            found = _adam_node(node)
            if found is not None:
                return found
    return None


def from_jax_train_state(state, param_keys: Sequence[str]) -> dict:
    """A whole JAX ``TrainState`` (as ``jax.device_get`` returns it: numpy
    leaves) -> the port's snapshot state, ``{"model": state_dict,
    "optimizer": Optimizer.state_dict()}``.

    The parameters and batch statistics map as in ``from_jax_params``;
    optax Adam's ``mu``/``nu`` (found in ``opt_state``, bare or inside a
    chain) take the same transposes as ``exp_avg``/``exp_avg_sq``, and its
    update ``count`` is each parameter's torch ``step`` and the port's
    ``count``.  ``param_keys`` lists the model's parameter keys in
    ``named_parameters()`` order, the index torch's optimizer state uses.
    The optimizer part carries no ``param_groups``: the hyperparameters
    are the loading ``Optimizer``'s own."""
    adam = _adam_node(state.opt_state)
    if adam is None:
        raise ValueError("no Adam moments (mu, nu) in the JAX optimizer state")
    count = int(adam.count)
    exp_avg, exp_avg_sq = from_jax_params(adam.mu, ()), from_jax_params(adam.nu, ())
    per_param = {i: {"step": torch.tensor(float(count)), "exp_avg": exp_avg[key],
                     "exp_avg_sq": exp_avg_sq[key]}
                 for i, key in enumerate(param_keys)}
    return {"model": from_jax_params(state.params, state.batch_stats),
            "optimizer": {"inner": {"state": per_param}, "count": count}}


def lm_params_from_jax(tree: Mapping) -> dict:
    """The nested numpy parameter tree of the JAX ``TransformerLM.init``
    (unboxed) -> a ``state_dict`` for ``models.transformer.TransformerLM``.
    The port keeps Flax's names and layouts (dense kernels (in, out), the
    head kernel (vocab, d_model)), so the key is the tree path joined by
    dots and every array is copied as it is: float leaves as f32, and the
    int8 kernels of a weight-only int8 tree (``quantize_lm_params``) as
    int8."""
    return {".".join(path): torch.tensor(_lm_leaf(value)) for path, value in _flatten(tree)}


def _lm_leaf(value) -> np.ndarray:
    arr = np.asarray(value)
    return arr if arr.dtype == np.int8 else arr.astype(np.float32)


def lm_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A ``TransformerLM`` ``state_dict`` -> the JAX nested tree of numpy
    arrays, the inverse of ``lm_params_from_jax``."""
    tree: dict = {}
    for key, value in state_dict.items():
        *modules, leaf = key.split(".")
        node = tree
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = value.detach().cpu().numpy()
    return tree


def vit_params_from_jax(tree: Mapping) -> dict:
    """The nested numpy parameter tree of the JAX ``ViT.init`` (unboxed)
    -> a ``state_dict`` for ``models.vit.ViT``: ``patch_embed``'s kernel
    HWIO -> ``weight`` OIHW and its bias; ``pos_embed``, the ``block{i}``
    subtrees, ``norm_f`` and ``head`` by the LM's mapping (Flax names and
    layouts)."""
    tree = dict(tree)
    conv = tree.pop("patch_embed")
    sd = lm_params_from_jax(tree)
    sd["patch_embed.weight"] = torch.tensor(
        np.ascontiguousarray(np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1)))
    sd["patch_embed.bias"] = torch.tensor(np.asarray(conv["bias"], np.float32))
    return sd


def vit_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A ``ViT`` ``state_dict`` -> the JAX nested tree of numpy arrays, the
    inverse of ``vit_params_from_jax``."""
    rest = {k: v for k, v in state_dict.items() if not k.startswith("patch_embed.")}
    tree = lm_params_to_jax(rest)
    weight = state_dict["patch_embed.weight"].detach().cpu().numpy()
    tree["patch_embed"] = {
        "kernel": np.ascontiguousarray(weight.transpose(2, 3, 1, 0)),
        "bias": state_dict["patch_embed.bias"].detach().cpu().numpy(),
    }
    return tree


def _model_dims(spec) -> list[int]:
    return [i for i, e in enumerate(spec)
            if e == "model" or (isinstance(e, tuple) and "model" in e)]


def _cut(t: torch.Tensor, spec, model: int, index: int) -> torch.Tensor:
    for dim in _model_dims(spec):
        n = t.shape[dim]
        part = -(-n // model)
        if part * model != n:
            pad = list(t.shape)
            pad[dim] = part * model - n
            t = torch.cat([t, t.new_zeros(pad)], dim)
        t = t.narrow(dim, index * part, part)
    return t.contiguous()


def _join(parts: Sequence[torch.Tensor], spec, shape=None) -> torch.Tensor:
    dims = _model_dims(spec)
    if not dims:
        return parts[0]
    t = torch.cat([p.to(parts[0].device) for p in parts], dims[0])
    if shape is not None:
        t = t.narrow(dims[0], 0, shape[dims[0]])
    return t.contiguous()


def _param_specs(table, model_sd: Mapping) -> dict:
    return table.specs({k: v for k, v in model_sd.items()})


def _map_optimizer(opt: dict, keys: list, fn) -> dict:
    """``opt`` (an ``Optimizer.state_dict()``, per-parameter entries indexed
    in ``keys``' order) with every param-shaped moment ``v`` of key ``k``
    replaced by ``fn(k, v)``."""
    state = opt["inner"]["state"]
    inner = dict(opt["inner"], state={
        i: {name: (fn(keys[i], v) if name != "step" and isinstance(v, torch.Tensor)
                   and v.dim() > 0 else v) for name, v in st.items()}
        for i, st in state.items()})
    return dict(opt, inner=inner)


def shard_state(state: dict, table, model: int, index: int) -> dict:
    """Rank ``index``'s part of a one-device snapshot state on a ``model``
    axis of that many ranks, under ``table`` (the other entries kept;
    ``model`` 1 returns the state as it is)."""
    if model <= 1:
        return state
    sd = state["model"]
    specs = _param_specs(table, sd)
    out = dict(state, model={k: _cut(v, specs[k], model, index) for k, v in sd.items()})
    if "optimizer" in state:
        keys = list(sd)
        out["optimizer"] = _map_optimizer(state["optimizer"], keys,
                                          lambda k, v: _cut(v, specs[k], model, index))
    return out


def gather_state(parts: Sequence[dict], table, shapes: Mapping | None = None) -> dict:
    """The one-device snapshot state from the ``model`` ranks' parts (in
    rank order), under ``table``, each joined tensor on its first part's
    device; ``shapes`` (each key's one-device shape) strips the padding of
    an uneven split."""
    if len(parts) == 1:
        return parts[0]
    sd0 = parts[0]["model"]
    specs = _param_specs(table, sd0)
    shapes = shapes or {}

    def join(k, vs):
        return _join(vs, specs[k], shapes.get(k))

    out = dict(parts[0], model={k: join(k, [p["model"][k] for p in parts]) for k in sd0})
    if "optimizer" in parts[0]:
        keys = list(sd0)
        states = [p["optimizer"]["inner"]["state"] for p in parts]
        opt = parts[0]["optimizer"]
        inner = dict(opt["inner"], state={
            i: {name: (join(keys[i], [st[i][name] for st in states])
                       if name != "step" and isinstance(v, torch.Tensor) and v.dim() > 0
                       else v) for name, v in s0.items()}
            for i, s0 in states[0].items()})
        out["optimizer"] = dict(opt, inner=inner)
    return out


def shard_lm_state(state: dict, spec, index: int) -> dict:
    """``shard_state`` under ``lm_rules``: rank ``index`` of ``spec.model``
    (an ``LMMeshSpec``)."""
    from ddl_tpu_torch.parallel.rules import lm_rules

    return shard_state(state, lm_rules(), spec.model, index)


def gather_lm_state(parts: Sequence[dict], vocab_size: int | None = None) -> dict:
    """``gather_state`` under ``lm_rules``; ``vocab_size`` strips the
    padding of the last vocab shard."""
    from ddl_tpu_torch.parallel.rules import lm_rules

    shapes = None
    if vocab_size is not None:
        d = parts[0]["model"]
        shapes = {k: (vocab_size, d[k].shape[1]) for k in ("embed.embedding", "lm_head.kernel")
                  if k in d}
    return gather_state(parts, lm_rules(), shapes)


def shard_vit_state(state: dict, spec, index: int) -> dict:
    """``shard_state`` under ``vit_rules``."""
    from ddl_tpu_torch.parallel.rules import vit_rules

    return shard_state(state, vit_rules(), spec.model, index)


def gather_vit_state(parts: Sequence[dict]) -> dict:
    """``gather_state`` under ``vit_rules``."""
    from ddl_tpu_torch.parallel.rules import vit_rules

    return gather_state(parts, vit_rules())
