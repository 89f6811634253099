"""Loss ops (counterpart of ``ddl_tpu/ops/losses.py``).

Besides the dense cross-entropy, the two chunked head+CE losses of the LM's
loss edge, which never hold the whole (B, T, V) f32 logits:

* ``fused_chunked_ce`` (``ce_chunk``): a loop over sequence chunks, each
  chunk's head product and CE under ``torch.utils.checkpoint`` so the
  backward recomputes that chunk's (B, C, V) logits instead of keeping them;
* ``fused_vocab_chunked_ce`` (``ce_vocab_chunk``): an online logsumexp over
  vocab blocks in the forward and a hand-written backward that re-runs the
  blocks, so no tensor wider than one (B, T, Vb) block exists in either
  direction.

The head products are f32 ``torch.matmul``s (the JAX ``einsum``s are
outside any Pallas kernel); on the card they need TF32 off to be exact f32.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = [
    "cross_entropy_loss",
    "effective_chunk",
    "fused_chunked_ce",
    "fused_vocab_chunked_ce",
    "onehot_cross_entropy_mean",
    "softmax_cross_entropy",
]


def effective_chunk(token_chunk: int, t: int) -> int:
    """The chunk size actually used: the largest divisor of ``t`` at or
    under the request."""
    c = min(token_chunk, t)
    while t % c:
        c -= 1
    return c


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy from integer labels, in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return lse - picked


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy — the training objective."""
    return softmax_cross_entropy(logits, labels).mean()


def _picked_onehot(logits, labels):
    return (logits * F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)).sum(-1)


def onehot_cross_entropy_mean(logits, labels):
    """Mean softmax cross-entropy in the one-hot elementwise form: returns
    ``(mean_ce, f32_logits)``."""
    logits = logits.float()
    return (torch.logsumexp(logits, dim=-1) - _picked_onehot(logits, labels)).mean(), logits


def _chunk_ce(h_c, w, t_c, with_accuracy: bool, use_onehot: bool):
    """One sequence chunk: its (B, C, V) f32 logits, reduced to the CE sum
    and the argmax hits."""
    logits = h_c.float() @ w.t()
    lse = torch.logsumexp(logits, dim=-1)
    if use_onehot:
        picked = _picked_onehot(logits, t_c)
    else:
        picked = torch.gather(logits, -1, t_c.long()[..., None])[..., 0]
    ce_sum = (lse - picked).sum()
    if with_accuracy:
        return ce_sum, (logits.argmax(-1) == t_c).sum()
    return ce_sum, torch.zeros((), dtype=torch.int64, device=ce_sum.device)


def fused_chunked_ce(hidden, w, targets, token_chunk: int, with_accuracy: bool = False,
                     use_onehot: bool = False):
    """Head projection and mean cross-entropy over chunks of ``token_chunk``
    sequence positions (the largest divisor of T at or under it, with a
    warning when that is not the request).  Each chunk runs under
    ``torch.utils.checkpoint``, so only one chunk's logits are alive at a
    time, forward or backward.

    hidden: (B, T, D) post-final-norm activations; w: (V, D) f32 head
    kernel (vocab-major); targets: (B, T) int.  Returns ``(mean_ce,
    accuracy | None)``.  ``use_onehot`` takes the picked logit by a one-hot
    product instead of a gather (the same math)."""
    b, t, _ = hidden.shape
    if token_chunk < 1:
        raise ValueError(f"token_chunk must be >= 1, got {token_chunk}")
    c = effective_chunk(token_chunk, t)
    if c != min(token_chunk, t):
        warnings.warn(
            f"token_chunk {token_chunk} does not divide T={t}; using the largest divisor {c}",
            stacklevel=2,
        )
    ce = hidden.new_zeros((), dtype=torch.float32)
    hits = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(0, t, c):
        args = (hidden[:, i:i + c], w, targets[:, i:i + c], with_accuracy, use_onehot)
        if torch.is_grad_enabled():
            ce_sum, h = checkpoint(_chunk_ce, *args, use_reentrant=False)
        else:
            ce_sum, h = _chunk_ce(*args)
        ce, hits = ce + ce_sum, hits + h
    n = b * t
    return ce / n, (hits.float() / n if with_accuracy else None)


def _vocab_blocks(v: int, vocab_chunk: int) -> int:
    """The vocab-block size actually used (``effective_chunk`` on the vocab
    axis), with a warning when the request does not divide V."""
    if vocab_chunk < 1:
        raise ValueError(f"vocab_chunk must be >= 1, got {vocab_chunk}")
    c = effective_chunk(vocab_chunk, v)
    if c != min(vocab_chunk, v):
        warnings.warn(
            f"vocab_chunk {vocab_chunk} does not divide V={v}; using the largest divisor {c}",
            stacklevel=3,
        )
    return c


class _VocabChunkedCE(torch.autograd.Function):
    """The vocab-streamed loss edge with its hand-written backward; ``vb``
    is the block size already resolved by ``_vocab_blocks``."""

    @staticmethod
    def forward(ctx, hidden, w, targets, vb: int, with_accuracy: bool):
        b, t, _ = hidden.shape
        h32 = hidden.float()
        tgt = targets.long()
        m = torch.full((b, t), -torch.inf, device=hidden.device)
        s = torch.zeros((b, t), device=hidden.device)
        picked = torch.zeros((b, t), device=hidden.device)
        best = torch.full((b, t), -torch.inf, device=hidden.device)
        best_idx = torch.zeros((b, t), dtype=torch.long, device=hidden.device)
        for off in range(0, w.shape[0], vb):
            z = h32 @ w[off:off + vb].float().t()  # (B, T, Vb)
            zmax = z.amax(-1)
            new_m = torch.maximum(m, zmax)
            s = s * torch.exp(m - new_m) + torch.exp(z - new_m[..., None]).sum(-1)
            m = new_m
            local = tgt - off
            in_blk = (local >= 0) & (local < vb)
            z_t = torch.gather(z, -1, local.clamp(0, vb - 1)[..., None])[..., 0]
            picked = torch.where(in_blk, z_t, picked)
            if with_accuracy:
                # an earlier block keeps a tie (strict >); argmax takes the
                # first index within a block
                best_idx = torch.where(zmax > best, z.argmax(-1) + off, best_idx)
                best = torch.maximum(best, zmax)
        lse = m + torch.log(s)
        ce = (lse - picked).mean()
        acc = (best_idx == tgt).float().mean() if with_accuracy else torch.zeros(
            (), device=hidden.device)
        ctx.save_for_backward(hidden, w, targets, lse)
        ctx.vb = vb
        ctx.mark_non_differentiable(acc)
        return ce, acc

    @staticmethod
    def backward(ctx, g_ce, _g_acc):
        hidden, w, targets, lse = ctx.saved_tensors
        vb = ctx.vb
        b, t, d = hidden.shape
        h32 = hidden.float()
        tgt = targets.long()
        scale = g_ce / (b * t)
        dx = torch.zeros((b, t, d), device=hidden.device)
        dw = torch.empty(w.shape, device=w.device)
        for off in range(0, w.shape[0], vb):
            w_b = w[off:off + vb].float()
            dp = torch.exp_(h32 @ w_b.t() - lse[..., None])  # p, then p - onehot
            local = tgt - off
            in_blk = (local >= 0) & (local < vb)
            dp.scatter_add_(-1, local.clamp(0, vb - 1)[..., None], -in_blk.float()[..., None])
            dp.mul_(scale)
            dx += dp @ w_b
            dw[off:off + vb] = dp.reshape(-1, vb).t() @ h32.reshape(-1, d)
        return dx.to(hidden.dtype), dw.to(w.dtype), None, None, None


def fused_vocab_chunked_ce(hidden, w, targets, vocab_chunk: int, with_accuracy: bool = False):
    """Head projection and mean CE streamed over vocab blocks of
    ``vocab_chunk`` (the largest divisor of V at or under it): the forward
    carries a running max, sum of exponentials, the picked logit and the
    argmax; the backward re-runs the blocks, ``dp = (p - onehot) g / (B T)``,
    ``dx += dp @ W_b``, ``dW_b = dp^T @ h``, and returns ``dx`` in
    ``hidden.dtype`` and ``dW`` in ``w.dtype``.

    hidden: (B, T, D); w: (V, D) vocab-major; targets: (B, T) int.  Returns
    ``(mean_ce, accuracy | None)`` (accuracy is not differentiable)."""
    vb = _vocab_blocks(w.shape[0], vocab_chunk)
    ce, acc = _VocabChunkedCE.apply(hidden, w, targets, vb, with_accuracy)
    return ce, (acc if with_accuracy else None)
