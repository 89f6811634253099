"""Dense softmax attention (counterpart of ``ddl_tpu/ops/attention.py``).

The transformer's default attention core and the cached-attention path
for what the decode kernel does not take (T > 1 against a cache, a
windowed slice).  Every rounding point follows the JAX function: the
scores are a product in the compute dtype divided by ``sqrt(d)`` taken in
``q.dtype``, masked scores become -1e30 in that dtype (not -inf: a fully
masked row stays finite), the softmax runs in f32, and the probabilities
are cast back to ``q.dtype`` before the second product.
"""

from __future__ import annotations

import torch

__all__ = ["dense_attention"]


def dense_attention(q, k, v, causal: bool = False, mask=None, window: int = 0):
    """Full softmax attention. q: (B, Tq, H, D), k/v: (B, Tk, Hkv, D) ->
    (B, Tq, H, D).  ``mask`` is an explicit bool mask (True = attend),
    (Tq, Tk) shared by the batch or (B, Tq, Tk) per row; ``causal`` builds
    the square lower-triangular mask, banded to the last ``window``
    positions when ``window > 0``.

    Grouped-query attention (``Hkv < H``, ``H % Hkv == 0``) reshapes the
    query into (Hkv, H/Hkv) groups; K/V are never repeated to H heads."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if window and mask is not None:
        raise ValueError("pass window via the explicit mask, not both")
    if causal and mask is None:
        ones = torch.ones((tq, tq), dtype=torch.bool, device=q.device)
        mask = torch.tril(ones)
        if window:
            mask &= ~torch.tril(ones, -window)
    scale = torch.sqrt(torch.tensor(d, dtype=q.dtype, device=q.device))
    if hkv == h:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
        if mask is not None:
            m = mask[None, None] if mask.dim() == 2 else mask[:, None]
            scores = scores.masked_fill(~m, -1e30)
        probs = torch.softmax(scores.float(), -1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if h % hkv:
        raise ValueError(f"q heads {h} must divide by kv heads {hkv}")
    g = h // hkv
    qg = q.reshape(b, tq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / scale
    if mask is not None:
        m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
        scores = scores.masked_fill(~m, -1e30)
    probs = torch.softmax(scores.float(), -1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, tq, h, d)
