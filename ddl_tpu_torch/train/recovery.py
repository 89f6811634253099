"""In-loop recovery policy: what a run does about a non-finite loss (own
copy of ``ddl_tpu/train/recovery.py``).

``halt_on_nan`` turns a NaN excursion into a clean death with a pointer
at the last snapshot — a human still has to react.  This module is the
no-human version, driven by ``train/loop.BaseTrainer``:

* a non-finite period loss is recorded as an ``anomaly`` event and the
  period's metrics/eval/snapshot are **skipped** — a transient spike
  costs one period, not the run;
* after ``max_consecutive`` non-finite periods the policy declares the
  optimizer state poisoned and asks the trainer to **roll back** to the
  latest *valid* snapshot (``checkpoint.latest_valid_epoch``), entering a
  **reduced-LR grace window**: the next ``grace_periods`` finite periods
  run with updates scaled by ``grace_scale``;
* rollbacks are bounded (``max_rollbacks``): a run that NaNs through
  repeated rollback+grace cycles has a real bug and dies loudly.

The JAX package's ``scale_tx`` (an optax wrap that multiplies the updates
with an unchanged state tree) has its counterpart in the port's
``Optimizer.update_scale`` (``train/state.py``), which multiplies the
scheduled learning rate: Adam's update and AdamW's decoupled decay are
both proportional to it, so the whole update scales, and nothing is
rebuilt.
"""

from __future__ import annotations

__all__ = ["RecoveryPolicy", "make_policy"]


def make_policy(run) -> "RecoveryPolicy | None":
    """Build the policy a run config asks for — ``None`` for ``"halt"``,
    a ``RecoveryPolicy`` for ``"recover"``, a loud error for anything
    else (a typo'd policy name must not silently fall back to halting)."""
    if run.nan_policy not in ("halt", "recover"):
        raise ValueError(
            f"unknown nan_policy {run.nan_policy!r} "
            "(want 'halt' or 'recover')"
        )
    if run.nan_policy == "halt":
        return None
    return RecoveryPolicy(
        max_consecutive=run.nan_max_consecutive,
        grace_scale=run.nan_grace_scale,
        grace_periods=run.nan_grace_periods,
    )


class RecoveryPolicy:
    """Consecutive-failure counter + rollback/grace bookkeeping.

    The loop calls ``on_nonfinite()`` per bad period (returns ``"skip"``
    or ``"rollback"``), ``on_rollback()`` when the trainer restored a
    snapshot, and ``on_finite()`` per good period (returns True exactly
    when a grace window just ended and the update scale must return to
    1).
    """

    def __init__(
        self,
        max_consecutive: int = 3,
        grace_scale: float = 0.1,
        grace_periods: int = 2,
        max_rollbacks: int = 2,
    ) -> None:
        if max_consecutive < 1:
            raise ValueError(
                f"max_consecutive must be >= 1, got {max_consecutive}"
            )
        self.max_consecutive = max_consecutive
        self.grace_scale = grace_scale
        self.grace_periods = grace_periods
        self.max_rollbacks = max_rollbacks
        self.consecutive = 0
        self.grace_left = 0
        self.rollbacks = 0
        self.skipped = 0

    @property
    def in_grace(self) -> bool:
        return self.grace_left > 0

    def on_nonfinite(self) -> str:
        self.consecutive += 1
        if self.consecutive >= self.max_consecutive:
            return "rollback"
        self.skipped += 1
        return "skip"

    def on_rollback(self) -> None:
        self.rollbacks += 1
        self.consecutive = 0
        self.grace_left = self.grace_periods

    def on_finite(self) -> bool:
        self.consecutive = 0
        if self.grace_left > 0:
            self.grace_left -= 1
            return self.grace_left == 0
        return False
