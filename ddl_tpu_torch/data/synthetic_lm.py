"""Synthetic LM corpus: byte sequences from a fixed order-1 Markov chain
(own copy of ``ddl_tpu/data/synthetic_lm.py``).

Learnable structure with a known entropy floor.  The chain is defined by
seed 0 and its sequences come from the caller's numpy generator, so the
same generator gives bit-equal sequences in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MarkovChain"]


class MarkovChain:
    """256-state chain; each byte has 8 likely successors with Dirichlet
    weights.  ``sample(rng, batch, length)`` draws sequences; ``succ[b]``
    lists byte ``b``'s plausible successors (the top-8 support)."""

    def __init__(self, seed: int = 0, vocab: int = 256, fanout: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.trans = rng.dirichlet(np.full(fanout, 0.2), size=vocab)
        self.succ = rng.integers(0, vocab, (vocab, fanout))
        self.cum = self.trans.cumsum(axis=1)

    def sample(self, rng: np.random.Generator, batch: int, length: int):
        """(batch, length) int32 sequences following the chain."""
        seqs = np.empty((batch, length), np.int32)
        seqs[:, 0] = rng.integers(0, self.vocab, batch)
        for t in range(length - 1):
            u = rng.random((batch, 1))
            choice = (self.cum[seqs[:, t]] > u).argmax(axis=1)
            seqs[:, t + 1] = self.succ[seqs[:, t], choice]
        return seqs

    def on_chain_fraction(self, prompts: np.ndarray, generated: np.ndarray):
        """Fraction of generated steps that follow a top-8 transition from
        their predecessor (prompt context included).  Random tokens score
        ~fanout/vocab."""
        full = np.concatenate([prompts, generated], axis=1)
        p = prompts.shape[1]
        hits = [
            full[b, j] in self.succ[full[b, j - 1]]
            for b in range(full.shape[0])
            for j in range(p, full.shape[1])
        ]
        return float(np.mean(hits))
