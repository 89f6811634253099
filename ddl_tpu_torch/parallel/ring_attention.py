"""Ring attention: sequence parallelism over the ``seq`` ranks (counterpart
of ``ddl_tpu/parallel/ring_attention.py``).

Each rank of a ``seq`` group holds one block of ``T_local`` positions of
the sequence: its Q block stays, and the K/V blocks rotate around the ring
(``parallel.mesh.ppermute``), one hop a step, so rank ``s`` sees at hop
``i`` the block that started at rank ``(s - i) mod n``.  The softmax is
accumulated across hops, so no rank holds more than one ``T_local x
T_local`` score block.  Causal masking is on global positions; a block
wholly in the future still runs (every rank runs the same hops) and
contributes nothing.

Two ways to attend one hop, as in the JAX module:

* the dense block (``_block_attention``, plain PyTorch: JAX computes it
  outside any Pallas kernel) with an online max / sum carry;
* ``use_flash``: the flash kernels (``ops/flash_attention.
  flash_attention_with_lse``, kernels #4-#6 on a card, their plain
  versions on the CPU) on each hop -- the causal diagonal first, then
  ``causal=False`` hops whose lse is set to -1e30 where the block comes
  from the future -- combined by logsumexp.  Under a sliding window the
  hops are a Python unroll cut at ``ceil((window + T_local - 1) /
  T_local)``, hop ``i`` banded in its own coordinates by ``kv_offset =
  i * T_local``.  Autograd runs through the combine, so each hop's
  backward is ``FlashAttentionFn``'s with the lse cotangent the combine
  gives it, and each rotation's backward is ``ppermute``'s reverse shift.

Grouped-query K/V (``Hkv < H``) is never repeated to H heads, so the hops
carry Hkv heads.  The JAX module's ``flash_block`` is the TPU kernel's
tiling; the port's kernels pick their own tiles.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ddl_tpu_torch.ops.flash_attention import flash_attention_with_lse
from ddl_tpu_torch.parallel.mesh import ppermute

__all__ = ["make_ring_self_attention", "ring_attention"]

_NEG_INF = -1e30


def _block_attention(q, k, v, mask, scale):
    """One Q block x K/V block with unnormalised accumulation: q (B, Tq, H,
    D), k/v (B, Tk, Hkv, D), mask (Tq, Tk) bool (True = keep) -> (block_acc
    (B, Tq, H, D), block_max (B, H, Tq), block_sum (B, H, Tq)), grouped K/V
    by reshaping the query."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, tq, hkv, h // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
    scores = torch.where(mask, scores, torch.full((), _NEG_INF, dtype=scores.dtype,
                                                  device=scores.device))
    blk_max = scores.amax(-1)
    p = torch.exp(scores - blk_max[..., None])
    # rows with no visible key: blk_max = -1e30, exp(0) = 1; zero them
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(b, tq, h, d)
    return acc, blk_max.reshape(b, h, tq), p.sum(-1).reshape(b, h, tq)


def ring_attention(q, k, v, group, causal: bool = False, use_flash: bool = False,
                   window: int = 0):
    """Attention over a ring-sharded sequence, on this rank's blocks: q
    (B, T_local, H, D), k/v (B, T_local, Hkv, D) -> this rank's output
    block (B, T_local, H, D), full softmax attention over the global
    sequence.  ``group`` is the ``seq`` ranks, this rank's position in it
    its block's (None: one rank, the diagonal hop alone).  ``use_flash``
    runs every hop through the flash kernels (``_ring_attention_flash``)."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    n, s = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
    if use_flash:
        return _ring_attention_flash(q, k, v, group, n, s, causal, window)
    b, t, h, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=q.dtype, device=q.device))
    local = torch.arange(t, device=q.device)
    # a window's hops past ceil((window + t - 1) / t) are outside every
    # row's band on every rank: the ring stops there
    n_hops = min(n, -(-(window + t - 1) // t)) if causal and window else n
    acc = torch.zeros_like(q)
    row_max = torch.full((b, h, t), _NEG_INF, dtype=q.dtype, device=q.device)
    row_sum = torch.zeros((b, h, t), dtype=q.dtype, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n_hops):
        if i:
            k_blk, v_blk = ppermute(k_blk, group), ppermute(v_blk, group)
        src = (s - i) % n  # the rank this K/V block started at
        if causal:
            q_pos = s * t + local
            kv_pos = src * t + local
            mask = kv_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= kv_pos[None, :] > q_pos[:, None] - window
        else:
            mask = torch.ones((t, t), dtype=torch.bool, device=q.device)
        blk_acc, blk_max, blk_sum = _block_attention(q, k_blk, v_blk, mask, scale)
        new_max = torch.maximum(row_max, blk_max)
        old_corr = torch.exp(row_max - new_max)
        blk_corr = torch.exp(blk_max - new_max)
        acc = (acc * old_corr.transpose(1, 2)[..., None]
               + blk_acc * blk_corr.transpose(1, 2)[..., None])
        row_sum = row_sum * old_corr + blk_sum * blk_corr
        row_max = new_max
    return acc / row_sum.clamp(min=1e-30).transpose(1, 2)[..., None]


def _ring_attention_flash(q, k, v, group, n: int, s: int, causal: bool, window: int):
    """Flash on every hop.  Hop 0 is the rank's own K/V under the kernel's
    causal mask; every later hop is wholly visible (its block started at a
    rank ``src < s``) or wholly in the future, and then its lse is set to
    -1e30 so it adds nothing (its kernels still run: every rank runs every
    hop).  Blocks combine by logsumexp in f32."""
    t = q.shape[1]
    out0, lse0 = flash_attention_with_lse(q, k, v, causal=causal, window=window)
    o_run, lse_run = out0.float(), lse0

    def combine(o_run, lse_run, o_blk, lse_blk, i):
        if causal and (s - i) % n >= s:
            lse_blk = torch.full_like(lse_blk, _NEG_INF)
        lse_new = torch.logaddexp(lse_run, lse_blk)
        w_run = torch.exp(lse_run - lse_new).transpose(1, 2)[..., None]
        w_blk = torch.exp(lse_blk - lse_new).transpose(1, 2)[..., None]
        return o_run * w_run + o_blk.float() * w_blk, lse_new

    if causal and window:
        # hop i's block sits i * t positions back: its band in the kernel's
        # own coordinates is kv_offset = i * t, and no row's band reaches
        # past the last hop of the cut
        n_hops = min(n, -(-(window + t - 1) // t))
        hop = dict(causal=True, window=window)
    else:
        n_hops, hop = n, dict(causal=False)
    k_blk, v_blk = k, v
    for i in range(1, n_hops):
        k_blk, v_blk = ppermute(k_blk, group), ppermute(v_blk, group)
        offset = i * t if window else 0
        o_blk, lse_blk = flash_attention_with_lse(q, k_blk, v_blk, kv_offset=offset, **hop)
        o_run, lse_run = combine(o_run, lse_run, o_blk, lse_blk, i)
    return o_run.to(q.dtype)


def make_ring_self_attention(mesh, causal: bool = False, use_flash: bool = False,
                             window: int = 0):
    """The attention core ``fn(q, k, v)`` of this rank of ``mesh`` (a
    ``parallel.mesh.LMMesh``, or None for one rank): ``ring_attention``
    over its ``seq_group``, on this rank's batch rows and sequence block,
    every head local (the JAX entry point's ``P('data', 'seq', 'model')``
    manual spec at ``model`` 1)."""
    group = None if mesh is None else mesh.seq_group

    def core(q, k, v):
        return ring_attention(q, k, v, group, causal=causal, use_flash=use_flash,
                              window=window)

    return core
