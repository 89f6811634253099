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

``fused`` marks the JAX package's fused Adam (``fused_adam``, its
single-pass Adam): set when the caller asks for it and the configuration
is plain Adam (no weight decay, no clipping), where the JAX package's
``make_optimizer`` builds ``fused_adam`` and not the optax chain.  It
changes nothing in the math; ``train/fused_optim.with_zero`` requires it,
as JAX's ``with_zero`` requires a ``FusedAdam``.

Under ZeRO-1 (``zero=``, attached by ``train/fused_optim.with_zero``) the
optimizer holds this rank's shard of the eligible leaves' moments and
steps them as one flat tensor with the same ``torch.optim.Adam``; the
small leaves keep a replicated Adam.  ``reduce_scatter_grads`` reduces
the gradients (the train step calls it in place of ``mean_over_data``),
``step`` all-gathers the new parameters, ``state_dict`` gathers the
moments into the replicated layout (a collective: every rank calls it)
and ``load_state_dict`` takes this rank's shard of them.

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
                 decay_steps: int = 0, fused: bool = False, zero=None) -> None:
        self.params = list(params)
        self._kw = dict(learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay, grad_clip_norm=grad_clip_norm,
                        lr_schedule=lr_schedule, warmup_steps=warmup_steps,
                        decay_steps=decay_steps, fused=fused)
        self.schedule = _schedule(learning_rate, lr_schedule, warmup_steps, decay_steps)
        self.grad_clip_norm = grad_clip_norm
        self.fused = fused and weight_decay == 0.0 and grad_clip_norm == 0.0
        self.count = 0
        self.update_scale = 1.0
        # squared-norm tensor -> its sum over the pipeline's stages (None:
        # this optimizer holds every parameter of the model)
        self.norm_reduce: Callable[[torch.Tensor], torch.Tensor] | None = None
        # ZeRO-1: the placement (None: replicated), this rank's flat shard
        # of the eligible leaves and the Adam that steps it
        self.zero = self.shard = self.shard_inner = None
        replicated = self.params
        if zero is not None:
            from ddl_tpu_torch.train.fused_optim import ZeroPlacement

            if not self.fused:
                raise ValueError("ZeRO-1 shards plain Adam only (fused, no weight decay, "
                                 "no clipping)")
            placement = ZeroPlacement(self.params, zero)
            if placement.shard_numel:
                self.zero = placement
                replicated = [self.params[i] for i in placement.small]
                ref = self.params[placement.leaves[0][0]]
                self.shard = torch.zeros(placement.shard_numel, dtype=ref.dtype,
                                         device=ref.device)
                self.shard_inner = torch.optim.Adam([self.shard], lr=self.schedule(0),
                                                    betas=(b1, b2), eps=eps)
        if weight_decay > 0.0:
            self.inner = torch.optim.AdamW(replicated, lr=self.schedule(0), betas=(b1, b2),
                                           eps=eps, weight_decay=weight_decay)
        else:
            self.inner = torch.optim.Adam(replicated, lr=self.schedule(0), betas=(b1, b2),
                                          eps=eps) if replicated else None

    def rebuild(self, **overrides) -> "Optimizer":
        """The same optimizer over the same parameters with ``overrides``
        of the constructor's keywords (``zero=``: ``with_zero``), its count,
        update scale and state carried over."""
        new = Optimizer(self.params, **{"zero": None, **self._kw, **overrides})
        new.update_scale, new.norm_reduce = self.update_scale, self.norm_reduce
        if self.count:
            new.load_state_dict(self.state_dict())
        return new

    def _optimizers(self) -> list:
        return [o for o in (self.inner, self.shard_inner) if o is not None]

    def zero_grad(self) -> None:
        if self.zero is None:
            self.inner.zero_grad(set_to_none=True)
            return
        for p in self.params:
            p.grad = None
        self.shard.grad = None

    def learning_rate(self) -> float:
        """The learning rate of the next update: the schedule at ``count``
        times ``update_scale``."""
        return self.schedule(self.count) * self.update_scale

    def _group_template(self) -> dict:
        """The replicated layout's one parameter group (a ZeRO state's)."""
        opt = self.inner if self.inner is not None else self.shard_inner
        group = opt.state_dict()["param_groups"][0]
        return {**group, "params": list(range(len(self.params)))}

    def state_dict(self) -> dict:
        """``{"inner": torch's Adam state_dict over every parameter,
        "count"}``.  Under ZeRO the same replicated layout, the moments of
        the sharded leaves gathered from every rank: a collective, which
        every rank of the data axis must call."""
        if self.zero is None:
            return {"inner": self.inner.state_dict(), "count": self.count}
        z = self.zero
        state = {}
        if self.inner is not None:
            small = self.inner.state_dict()["state"]
            state.update({i: small[j] for j, i in enumerate(z.small) if j in small})
        shard = self.shard_inner.state.get(self.shard)
        if shard:
            like = [self.params[i] for i, _ in z.leaves]
            moments = {k: z.gather_full(shard[k], like) for k in ("exp_avg", "exp_avg_sq")}
            for k, (i, _) in enumerate(z.leaves):
                state[i] = {"step": shard["step"].clone(), "exp_avg": moments["exp_avg"][k],
                            "exp_avg_sq": moments["exp_avg_sq"][k]}
        return {"inner": {"state": dict(sorted(state.items())),
                          "param_groups": [self._group_template()]},
                "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Load in place: the parameters stay the live tensors.  Adam's
        per-parameter ``step`` goes back to the host, where a fresh torch
        Adam keeps it (on the card, each update would read it back).  A
        state without ``param_groups`` (``models.convert.from_jax_train_state``)
        keeps this optimizer's hyperparameters.  Under ZeRO this rank takes
        its shard of the sharded leaves' moments, from a state of the
        replicated layout (whichever world wrote it)."""
        inner = state["inner"]
        per_param = {i: {k: v.cpu() if k == "step" else v for k, v in st.items()}
                     for i, st in inner["state"].items()}
        self.count = int(state["count"])
        if self.zero is None:
            self.inner.load_state_dict({"param_groups": self.inner.state_dict()["param_groups"],
                                        **inner, "state": per_param})
            return
        z = self.zero
        if self.inner is not None:
            self.inner.load_state_dict({
                "param_groups": self.inner.state_dict()["param_groups"],
                "state": {j: per_param[i] for j, i in enumerate(z.small) if i in per_param}})
        big = [per_param.get(i) for i, _ in z.leaves]
        groups = self.shard_inner.state_dict()["param_groups"]
        if all(b is None for b in big):
            self.shard_inner.load_state_dict({"param_groups": groups, "state": {}})
            return
        if any(b is None for b in big):
            raise ValueError("the optimizer state holds moments for some sharded leaves "
                             "and not for others")
        dev = self.shard.device
        self.shard_inner.load_state_dict({"param_groups": groups, "state": {0: {
            "step": big[0]["step"].clone(),
            **{k: z.take([b[k].to(dev) for b in big]) for k in ("exp_avg", "exp_avg_sq")}}}})

    def state_bytes(self) -> int:
        """This rank's bytes of Adam's moments: under ZeRO its shard of the
        sharded leaves' and the small leaves' whole.  The per-parameter
        ``step`` scalars live on the host and are not counted."""
        return sum(v.numel() * v.element_size() for opt in self._optimizers()
                   for per_param in opt.state.values() for k, v in per_param.items()
                   if k != "step" and isinstance(v, torch.Tensor))

    @torch.no_grad()
    def reduce_scatter_grads(self, gather: bool = False) -> None:
        """ZeRO's gradient reduction: the eligible leaves' gradients in
        one reduce-scatter of the placement's flat buffer (their mean
        shard becomes the shard's gradient, and their own ``.grad`` is
        released), the small leaves' averaged by ``mean_over_data``.  With
        ``gather`` the mean shards are also all-gathered back into every
        leaf's ``.grad`` (for a reader of whole gradients, such as the
        gradient statistics)."""
        from ddl_tpu_torch.parallel.mesh import mean_over_data

        z = self.zero
        leaves = [self.params[i] for i, _ in z.leaves]
        if any(p.grad is None for p in leaves):
            raise RuntimeError("ZeRO-1 needs a gradient for every sharded leaf")
        self.shard.grad = z.reduce_scatter_mean(z.pack([p.grad for p in leaves]))
        for p in leaves:
            p.grad = None
        mean_over_data([self.params[i].grad for i in z.small
                        if self.params[i].grad is not None], z.mesh)
        if gather:
            for p, g in zip(leaves, z.gather_full(self.shard.grad, leaves)):
                p.grad = g

    @torch.no_grad()
    def step(self) -> None:
        if self.zero is not None and self.shard.grad is None:
            self.reduce_scatter_grads()
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
        for opt in self._optimizers():
            for group in opt.param_groups:
                group["lr"] = lr
        if self.inner is not None:
            self.inner.step()
        if self.zero is not None:
            z, leaves = self.zero, [self.params[i] for i, _ in self.zero.leaves]
            # the live parameters are the master copy: a restore or a
            # broadcast may have written them since the last step
            z.take_into(self.shard, leaves)
            self.shard_inner.step()
            z.unpack(z.all_gather(self.shard), leaves)
            self.shard.grad = None
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
