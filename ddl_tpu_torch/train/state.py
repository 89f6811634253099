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

``fused_adam`` (the JAX package's single-pass Adam) changes nothing in the
math; ``Optimizer`` takes ``fused`` as the JAX ``build_optimizer`` does and
ignores it.
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
        if weight_decay > 0.0:
            self.inner = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=(b1, b2),
                                           eps=eps, weight_decay=weight_decay)
        else:
            self.inner = torch.optim.Adam(self.params, lr=self.schedule(0), betas=(b1, b2),
                                          eps=eps)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip_norm > 0.0 and grads:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            for g in grads:
                g.mul_(scale)
        lr = self.schedule(self.count)
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
