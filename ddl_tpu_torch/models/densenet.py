"""DenseNet-121 in PyTorch, train- and eval-mode forward (counterpart of
``ddl_tpu/models/densenet.py``).

Module and parameter names are torchvision's (``features.conv0``,
``features.denseblock1.denselayer1.norm1.weight``, ``features.transition1``,
``features.norm5``, ``classifier``), so ``state_dict()`` keys match a
torchvision DenseNet and ``models/convert.py`` maps the JAX package's
parameter tree onto them leaf for leaf.

Layout: the public input is NHWC (B, H, W, 3) in the compute dtype, as in
the JAX package; inside, tensors are NCHW views with ``channels_last``
memory (a permute, no copy), which is what cuDNN wants, and a fused dense
block gets its NHWC input the same way.  Parameters stay float32 and are
cast to the compute dtype at each op.  BatchNorm folds its statistics
into one affine, ``relu(x * a + b)`` in f32 with a = rsqrt(var + eps) *
weight and b = bias - mean * a, then a cast to the compute dtype — the JAX
package's arithmetic.  In eval mode the statistics are the running ones.
In training mode (``model.train()``) they are the batch's, in f32 with
var = E[x^2] - E[x]^2 clipped at 0 (``_batch_stats``, as Flax), and the
gradient flows through them; the running statistics then move by
``ra = 0.9 * ra + 0.1 * batch`` with the *biased* batch variance, as the
JAX package and Flax ``nn.BatchNorm`` do (``F.batch_norm`` would use the
unbiased one).  With ``data_group`` set (a process group over the ranks
of a data-parallel world, as torch's ``SyncBatchNorm`` takes its
``process_group``; ``train.steps.make_train_step`` sets it from its mesh)
the batch statistics are those of the global batch (``_batch_stats``),
so every rank's running statistics stay equal and the run equals
one-device training on the same global batch.

Dense blocks run in plain PyTorch (cuDNN convs, one concat per layer;
"packed", "concat" and "buffer" are the same math here), except under
``dense_block_impl="fused"``, where the blocks in
``dense_block_fused_blocks`` run through ``fused_fn`` (by default
``ops.fused_dense_block_fn``: the forward and backward CUDA kernels on a
GPU).  A fused block in training runs the JAX package's two phases: a
plain, differentiable stats pass (``_fused_stats_pass``) gives every
layer's batch statistics, ``pack_affines`` folds them, and the kernel
runs on the folded affines.

The network is described as a list of stages cut at dense-block
boundaries (``build_stage_specs``), as in the JAX package.  ``DenseNet(cfg,
stage=i)`` holds stage i's layers only, under the same names, for a
pipeline rank (``parallel/pipeline.py``); ``stage_boundary_shapes`` gives
the activations that cross the cuts.  A pipeline recomputes a stage's
forward in its backward (``ModelConfig.remat``) inside
``DenseNet.running_stats_frozen()``, so the recompute leaves the running
statistics where the forward moved them, as ``jax.checkpoint`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddl_tpu_torch.config import ModelConfig
from ddl_tpu_torch.ops.fused_dense_block import (
    BN_EPS,
    fused_block_takes,
    fused_dense_block_fn,
    pack_affines,
    pack_block_params,
)
from ddl_tpu_torch.parallel.mesh import sum_over_data

__all__ = ["DenseNet", "StageSpec", "build_stage_specs", "init_weights",
           "stage_boundary_shapes"]

# torch BatchNorm2d defaults: momentum 0.1 (EMA keep-rate 0.9), eps 1e-5.
_BN_MOMENTUM = 0.9


def _batch_stats(x: torch.Tensor, dims, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel batch mean and variance over ``dims``, Flax-BatchNorm
    style: f32, var = E[x^2] - E[x]^2 clipped at zero (the biased
    variance).  Under a ``group`` of ranks (a data-parallel world) the
    batch is the global one, as in the JAX package: each rank's sums of x
    and x^2 and its element count are summed over the ranks in one
    differentiable all-reduce, and the moments are formed from the
    totals."""
    xf = x.float()
    if group is None:
        mu = xf.mean(dims)
        return mu, torch.clamp((xf * xf).mean(dims) - mu * mu, min=0.0)
    count = math.prod(x.shape[d] for d in dims)
    local = torch.cat([xf.sum(dims), (xf * xf).sum(dims), xf.new_full((1,), count)])
    sums = sum_over_data(local, group)
    c = (sums.numel() - 1) // 2
    n = sums[-1]
    mu = sums[:c] / n
    return mu, torch.clamp(sums[c:2 * c] / n - mu * mu, min=0.0)


@torch.no_grad()
def _update_running(bn: nn.BatchNorm2d, mu: torch.Tensor, var: torch.Tensor) -> None:
    """ra = 0.9 * ra + 0.1 * batch, for the mean and the biased variance;
    nothing while ``bn.track_running_stats`` is off
    (``DenseNet.running_stats_frozen``)."""
    if not bn.track_running_stats:
        return
    bn.running_mean.copy_(_BN_MOMENTUM * bn.running_mean + (1 - _BN_MOMENTUM) * mu)
    bn.running_var.copy_(_BN_MOMENTUM * bn.running_var + (1 - _BN_MOMENTUM) * var)


def _affine_relu(x, mu, var, weight, bias, dtype, nchw: bool) -> torch.Tensor:
    """relu(x * a + b) in f32 with the statistics folded into a and b, then
    a cast to ``dtype``; ``x`` is NCHW or channels-last."""
    a = torch.rsqrt(var + BN_EPS) * weight
    b = bias - mu * a
    if nchw:
        a, b = a[:, None, None], b[:, None, None]
    return torch.relu(x.float() * a + b).to(dtype)


def _bn_relu(x: torch.Tensor, bn: nn.BatchNorm2d, dtype, group=None) -> torch.Tensor:
    """BatchNorm + ReLU on an NCHW tensor, folded to one f32 affine: batch
    statistics in training (over ``group``'s ranks; and a
    running-statistics update), the running ones in eval."""
    if bn.training:
        mu, var = _batch_stats(x, (0, 2, 3), group)
        _update_running(bn, mu, var)
    else:
        mu, var = bn.running_mean, bn.running_var
    return _affine_relu(x, mu, var, bn.weight, bn.bias, dtype, nchw=True)


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(dtype), None, conv.stride, conv.padding)


class DenseLayer(nn.Module):
    """Bottleneck layer: BN-ReLU-Conv1x1(bn_size*k) -> BN-ReLU-Conv3x3(k)."""

    def __init__(self, c_in: int, growth: int, bn_size: int) -> None:
        super().__init__()
        bn = bn_size * growth
        self.norm1 = nn.BatchNorm2d(c_in)
        self.conv1 = nn.Conv2d(c_in, bn, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(bn)
        self.conv2 = nn.Conv2d(bn, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor, dtype, group=None) -> torch.Tensor:
        """The layer's new ``growth`` channels."""
        h = _conv(_bn_relu(x, self.norm1, dtype, group), self.conv1, dtype)
        return _conv(_bn_relu(h, self.norm2, dtype, group), self.conv2, dtype)


def _fused_stats_pass(x: torch.Tensor, layers, dtype, group=None):
    """Phase one of a fused block's train-mode BatchNorm (the JAX package's
    ``_fused_stats_pass``): a plain, differentiable concat-form forward of
    the block on the NHWC input whose only products are each layer's
    batch statistics — ``(norm1_stats, norm2_stats)``, the ``(mean, var)``
    of every layer's full input and of its f32 bottleneck.  A per-image
    kernel cannot reduce across the batch between layers, so the kernel
    runs afterwards on these statistics folded into its affines, and the
    gradient through them flows back through this pass by autograd."""
    dims = (0, 1, 2)
    prefix = [_batch_stats(x, dims, group)]
    norm1, norm2 = [], []
    feats = x
    for i, layer in enumerate(layers):
        mu = torch.cat([m for m, _ in prefix])
        var = torch.cat([v for _, v in prefix])
        norm1.append((mu, var))
        hid = _affine_relu(feats, mu, var, layer.norm1.weight, layer.norm1.bias,
                           dtype, nchw=False)
        w1 = layer.conv1.weight.to(dtype).float().flatten(1)
        y1 = hid.float() @ w1.t()  # bf16 operands, f32 accumulation and result
        mu2, var2 = _batch_stats(y1, dims, group)
        norm2.append((mu2, var2))
        if i + 1 == len(layers):
            break  # the last layer's new strip feeds no BatchNorm of the block
        h2 = _affine_relu(y1, mu2, var2, layer.norm2.weight, layer.norm2.bias,
                          dtype, nchw=False)
        strip = _conv(h2.permute(0, 3, 1, 2), layer.conv2, dtype).permute(0, 2, 3, 1)
        prefix.append(_batch_stats(strip, dims, group))
        feats = torch.cat([feats, strip.to(feats.dtype)], -1)
    return norm1, norm2


class DenseBlock(nn.ModuleDict):
    """A run of dense layers (keys ``denselayer1..L``).  With ``fused_fn``
    set, the whole block runs through it on the NHWC view of the input
    where ``fused_block_takes`` the block's dtype, widths and device (the
    model does not know its device when it is built); otherwise, as with
    no ``fused_fn``, layer by layer through cuDNN (the packed block).
    In eval the layers' running statistics are folded by
    ``pack_block_params``, and the fold is cached until a parameter or
    buffer changes; in training ``_fused_stats_pass`` gives the batch
    statistics, folded afresh every call with f32 weights (``fused_fn``
    casts them)."""

    def __init__(self, num_layers: int, c_in: int, growth: int, bn_size: int,
                 fused_fn: Callable | None = None) -> None:
        super().__init__({
            f"denselayer{i + 1}": DenseLayer(c_in + i * growth, growth, bn_size)
            for i in range(num_layers)
        })
        self.fused_fn = fused_fn
        self.growth = growth
        self.bn_size = bn_size
        self._packed_key = None
        self._packed = None

    def _layer_states(self) -> list[dict[str, torch.Tensor]]:
        return [dict(layer.named_parameters()) | dict(layer.named_buffers())
                for layer in self.values()]

    def packed(self, dtype) -> dict:
        """The block's folded parameters for the fused kernel."""
        states = self._layer_states()
        key = (dtype, *((t.data_ptr(), t._version)
                        for s in states for t in s.values()))
        if key != self._packed_key:
            self._packed = pack_block_params(states, dtype)
            self._packed_key = key
        return self._packed

    def train_packed(self, x: torch.Tensor, dtype, group=None) -> dict:
        """The block's fold from the batch statistics of the NHWC input
        ``x`` (differentiable; over ``group``'s ranks), after moving the
        running statistics."""
        layers = list(self.values())
        norm1, norm2 = _fused_stats_pass(x, layers, dtype, group)
        for layer, (mu1, var1), (mu2, var2) in zip(layers, norm1, norm2):
            _update_running(layer.norm1, mu1, var1)
            _update_running(layer.norm2, mu2, var2)
        params = [dict(layer.named_parameters()) for layer in layers]
        return pack_affines(params, norm1, norm2, torch.float32)

    def forward(self, x: torch.Tensor, dtype, group=None) -> torch.Tensor:
        if self.fused_fn is not None and fused_block_takes(
                dtype, self.growth, self.bn_size, x.shape[1], x.device.type):
            nhwc = x.permute(0, 2, 3, 1).to(dtype).contiguous()
            packed = (self.train_packed(nhwc, dtype, group) if self.training
                      else self.packed(dtype))
            return self.fused_fn(nhwc, packed).permute(0, 3, 1, 2)
        feats = [x]
        for layer in self.values():
            feats.append(layer(torch.cat(feats, 1), dtype, group))
        return torch.cat(feats, 1)


class Transition(nn.Module):
    """BN-ReLU-Conv1x1 (channel halving) + 2x2 average pool, stride 2."""

    def __init__(self, c_in: int, c_out: int) -> None:
        super().__init__()
        self.norm = nn.BatchNorm2d(c_in)
        self.conv = nn.Conv2d(c_in, c_out, 1, bias=False)

    def forward(self, x: torch.Tensor, dtype, group=None) -> torch.Tensor:
        return F.avg_pool2d(_conv(_bn_relu(x, self.norm, dtype, group), self.conv, dtype), 2)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Which slice of the network a stage covers: blocks [start, end)."""

    start_block: int
    end_block: int
    has_stem: bool
    has_head: bool
    in_features: int  # channels entering the stage (3 for the stem stage)


def _features_entering_block(cfg: ModelConfig, block: int) -> int:
    f = cfg.num_init_features
    for b in range(block):
        f = (f + cfg.block_config[b] * cfg.growth_rate) // 2
    return f


def build_stage_specs(cfg: ModelConfig, num_stages: int | None = None) -> list[StageSpec]:
    """``num_stages=1`` (or ``cfg.split_blocks=()``) is the whole network as
    one stage; otherwise ``cfg.split_blocks`` are the blocks that begin
    stages 1..N-1 (as ``ddl_tpu.models.densenet.build_stages``)."""
    splits: Tuple[int, ...] = () if num_stages == 1 else tuple(cfg.split_blocks)
    n_blocks = len(cfg.block_config)
    if any(s <= 0 or s >= n_blocks for s in splits):
        raise ValueError(f"split_blocks {splits} out of range (1..{n_blocks - 1})")
    if list(splits) != sorted(set(splits)):
        raise ValueError(f"split_blocks {splits} must be strictly increasing")
    bounds = [0, *splits, n_blocks]
    return [
        StageSpec(
            start_block=bounds[i],
            end_block=bounds[i + 1],
            has_stem=i == 0,
            has_head=i == len(bounds) - 2,
            in_features=3 if i == 0 else _features_entering_block(cfg, bounds[i]),
        )
        for i in range(len(bounds) - 1)
    ]


def stage_boundary_shapes(cfg: ModelConfig, image_size: int) -> list[tuple[int, int, int]]:
    """(H, W, C) of the activation crossing each stage boundary (the JAX
    package's ``stage_boundary_shapes``): the spatial size entering block
    b is image_size / 4 (the stem) halved once per earlier transition."""
    shapes = []
    for spec in build_stage_specs(cfg)[1:]:
        hw = image_size // 4 // (2 ** spec.start_block)
        shapes.append((hw, hw, spec.in_features))
    return shapes


class DenseNet(nn.Module):
    """DenseNet with torchvision's names; forward over NHWC input.

    ``fused_fn(x0, packed)`` is what the fused blocks call (default:
    ``ops.fused_dense_block_fn``, the kernels on a GPU; a reference run
    passes ``fused_dense_block_fn_plain``, or ``fused_dense_block_plain``
    for eval only).  ``data_group`` (default None: this process's batch)
    is the process group over which train-mode BatchNorm takes its
    statistics.

    ``stage=i`` builds stage i of ``build_stage_specs(cfg, num_stages)``
    alone (``spec``): its modules keep the whole network's names, so a
    stage's ``state_dict`` is the whole one's restricted to its keys, and
    ``forward`` runs that stage (NHWC in; NHWC out, or the logits from
    the head stage)."""

    def __init__(self, cfg: ModelConfig, num_stages: int | None = None,
                 fused_fn: Callable = fused_dense_block_fn, stage: int | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.stages = build_stage_specs(cfg, num_stages)
        self.spec = None if stage is None else self.stages[stage]
        blocks = range(len(cfg.block_config)) if stage is None else range(
            self.spec.start_block, self.spec.end_block)
        g = cfg.growth_rate
        features = {}
        if stage is None or self.spec.has_stem:
            features["conv0"] = nn.Conv2d(3, cfg.num_init_features, 7, stride=2, padding=3,
                                          bias=False)
            features["norm0"] = nn.BatchNorm2d(cfg.num_init_features)
        n_blocks = len(cfg.block_config)
        c = _features_entering_block(cfg, blocks[0])
        for b in blocks:
            n_layers = cfg.block_config[b]
            fused = cfg.dense_block_impl == "fused" and b in tuple(cfg.dense_block_fused_blocks)
            features[f"denseblock{b + 1}"] = DenseBlock(
                n_layers, c, g, cfg.bn_size, fused_fn if fused else None
            )
            c += n_layers * g
            if b != n_blocks - 1:
                features[f"transition{b + 1}"] = Transition(c, c // 2)
                c //= 2
        head = blocks[-1] == n_blocks - 1
        if head:
            features["norm5"] = nn.BatchNorm2d(c)
        self.features = nn.ModuleDict(features)
        if head:
            self.classifier = nn.Linear(c, cfg.num_classes)
        self.data_group = None

    def forward_stage(self, spec: StageSpec, x: torch.Tensor) -> torch.Tensor:
        """One stage: NHWC in; NHWC out, or f32 logits from the head stage.
        Batch or running statistics follow ``self.training``."""
        f, dt, g = self.features, self.dtype, self.data_group
        x = x.to(dt).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        if spec.has_stem:
            x = _bn_relu(_conv(x, f["conv0"], dt), f["norm0"], dt, g)
            x = F.max_pool2d(x, 3, 2, 1)
        for b in range(spec.start_block, spec.end_block):
            x = f[f"denseblock{b + 1}"](x, dt, g)
            if f"transition{b + 1}" in f:
                x = f[f"transition{b + 1}"](x, dt, g)
        if not spec.has_head:
            return x.permute(0, 2, 3, 1)
        x = _bn_relu(x, f["norm5"], dt, g).float().mean((2, 3)).to(dt)
        w, b = self.classifier.weight.to(dt), self.classifier.bias.to(dt)
        return F.linear(x, w, b).float()

    @contextlib.contextmanager
    def running_stats_frozen(self):
        """Train-mode forwards inside this block normalize by their batch
        statistics as always but leave the running statistics where they
        are: a pipeline's recompute of a forward that already moved them.
        It turns off each BatchNorm's ``track_running_stats``, which the
        port reads only in ``_update_running``."""
        norms = [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
        for bn in norms:
            bn.track_running_stats = False
        try:
            yield
        finally:
            for bn in norms:
                bn.track_running_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """uint8-normalised images (B, H, W, 3) -> f32 logits (B, classes);
        a stage module: its stage's input -> its output."""
        if self.spec is not None:
            return self.forward_stage(self.spec, x)
        for spec in self.stages:
            x = self.forward_stage(spec, x)
        return x


def init_weights(model: nn.Module, seed: int) -> None:
    """torchvision's DenseNet initialisation, drawn from a ``torch.Generator``
    seeded with ``seed``: he-normal convs, unit/zero BatchNorm, zero
    classifier bias (the weight keeps ``nn.Linear``'s uniform rule)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5, generator=g)
                nn.init.zeros_(m.bias)
