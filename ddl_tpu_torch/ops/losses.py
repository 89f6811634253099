"""Loss ops (counterpart of ``ddl_tpu/ops/losses.py:33-45``)."""

from __future__ import annotations

import torch

__all__ = ["cross_entropy_loss", "softmax_cross_entropy"]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy from integer labels, in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return lse - picked


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy — the training objective."""
    return softmax_cross_entropy(logits, labels).mean()
