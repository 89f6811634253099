"""The optimizer (counterpart of ``ddl_tpu/train/state.py:29-117``).

``Optimizer`` is optax's Adam(W) with global-norm clipping and a
learning-rate schedule, on PyTorch's own optimizer: ``torch.optim.Adam``,
or ``torch.optim.AdamW`` when ``weight_decay > 0`` (the update is not a
TPU kernel in the JAX package, so the library optimizer is the port).
What differs between the two libraries, and how this module follows optax:

* Clipping: optax scales every gradient by ``max_norm / norm`` when the
  global norm reaches ``max_norm`` (``torch.nn.utils.clip_grad_norm_``
  adds 1e-6 to the norm and always multiplies), computed on the device
  without a host synchronisation.
* Schedules: optax evaluates the schedule at the update count *before*
  incrementing it, so step t (from 1) uses ``schedule(t - 1)``: a warmup
  run takes its first step at learning rate 0.
* Adam's bias correction and epsilon placement are the same math in both
  (``lr * m_hat / (sqrt(v_hat) + eps)``); AdamW's decoupled decay
  ``lr * wd * p`` is too.

In a pipeline each rank holds one stage's parameters, and the global norm
is still the JAX package's, over every stage: ``norm_reduce`` (set by
``parallel/pipeline.make_pipeline_step_fns``) sums this stage's squared
norm over the stages of its data row before the square root.

``fused_adam`` (the JAX package's single-pass Adam) changes nothing in the
math; ``Optimizer`` takes ``fused`` as the JAX ``build_optimizer`` does and
ignores it.

``update_scale`` multiplies the scheduled learning rate: the recovery
policy's reduced-LR grace window after a rollback (the JAX package's
``recovery.scale_tx``, which scales optax's updates).  Adam's update and
AdamW's decoupled decay are both proportional to the learning rate, so
the whole update scales, after clipping as there.  ``state_dict`` holds
torch's optimizer state (``exp_avg``, ``exp_avg_sq`` and the per-parameter
``step`` tensors) and ``count``, which drives the schedule; a snapshot
restores it with ``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

__all__ = ["Optimizer", "make_optimizer"]


def _schedule(learning_rate: float, lr_schedule: str = "constant",
                  warmup_steps: int = 0, decay_steps: int = 0) -> Callable[[int], float]:
    """``count -> lr`` as optax builds it in ``build_optimizer``: constant,
    or ``warmup_cosine_decay_schedule`` (to 0 at ``decay_steps``, which
    counts the warmup); ``warmup_steps`` prepends a linear 0 -> lr ramp to
    either."""
    if lr_schedule == "cosine":
        if decay_steps <= 0:
            raise ValueError("lr_schedule='cosine' requires decay_steps > 0")
        if warmup_steps >= decay_steps:
            raise ValueError(
                f"decay_steps ({decay_steps}) must exceed warmup_steps "
                f"({warmup_steps}) — it counts total steps including warmup"
            )
    elif lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return learning_rate * count / warmup_steps
        if lr_schedule == "constant":
            return learning_rate
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        return learning_rate * 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup_steps)))

    return schedule


class Optimizer:
    """Clip, then one Adam(W) update at the scheduled learning rate; the
    keywords are those of the JAX package's ``build_optimizer``.
    ``step()`` reads the parameters' ``.grad``; ``count`` is optax's update
    count."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip_norm: float = 0.0,
                 lr_schedule: str = "constant", warmup_steps: int = 0,
                 decay_steps: int = 0, fused: bool = False) -> None:
        self.params = list(params)
        self.schedule = _schedule(learning_rate, lr_schedule, warmup_steps, decay_steps)
        self.grad_clip_norm = grad_clip_norm
        self.count = 0
        self.update_scale = 1.0
        # squared-norm tensor -> its sum over the pipeline's stages (None:
        # this optimizer holds every parameter of the model)
        self.norm_reduce: Callable[[torch.Tensor], torch.Tensor] | None = None
        if weight_decay > 0.0:
            self.inner = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=(b1, b2),
                                           eps=eps, weight_decay=weight_decay)
        else:
            self.inner = torch.optim.Adam(self.params, lr=self.schedule(0), betas=(b1, b2),
                                          eps=eps)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def learning_rate(self) -> float:
        """The learning rate of the next update: the schedule at ``count``
        times ``update_scale``."""
        return self.schedule(self.count) * self.update_scale

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Load in place: the parameters stay the live tensors.  Adam's
        per-parameter ``step`` goes back to the host, where a fresh torch
        Adam keeps it (on the card, each update would read it back).  A
        state without ``param_groups`` (``models.convert.from_jax_train_state``)
        keeps this optimizer's hyperparameters."""
        inner = state["inner"]
        inner = {"param_groups": self.inner.state_dict()["param_groups"], **inner, "state": {
            i: {k: v.cpu() if k == "step" else v for k, v in per_param.items()}
            for i, per_param in inner["state"].items()}}
        self.inner.load_state_dict(inner)
        self.count = int(state["count"])

    def state_bytes(self) -> int:
        """Bytes of the optimizer state's tensors (the moments and steps)."""
        return sum(v.numel() * v.element_size() for per_param in self.inner.state.values()
                   for v in per_param.values() if isinstance(v, torch.Tensor))

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip_norm > 0.0 and grads:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            if self.norm_reduce is not None:
                norm = torch.sqrt(self.norm_reduce(norm * norm))
            scale = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            for g in grads:
                g.mul_(scale)
        lr = self.learning_rate()
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1


def make_optimizer(params, train_cfg) -> Optimizer:
    """Optimizer from a ``TrainConfig`` — the defaults are torch's
    unconfigured Adam (lr 1e-3, betas (0.9, 0.999), eps 1e-8)."""
    return Optimizer(
        params,
        train_cfg.learning_rate,
        b1=train_cfg.b1,
        b2=train_cfg.b2,
        eps=train_cfg.eps,
        weight_decay=train_cfg.weight_decay,
        grad_clip_norm=train_cfg.grad_clip_norm,
        lr_schedule=train_cfg.lr_schedule,
        warmup_steps=train_cfg.warmup_steps,
        decay_steps=train_cfg.decay_steps,
        fused=train_cfg.fused_adam,
    )
