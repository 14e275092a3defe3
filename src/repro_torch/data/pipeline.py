"""Deterministic synthetic LM data, the JAX package's ``data/pipeline.py``.

Stateless: ``batch = f(seed, step)``, so a restart at step k sees exactly
the batches an uninterrupted run would have seen, which makes a resumed
run bit-exact.  The tokens are Zipf-distributed unigrams over a capped
alphabet with a copy structure (``token[t] = token[t-4]`` on a random
mask), so the loss moves during short runs.  The stream comes from a
``torch.Generator`` seeded by ``(seed, step)``: its numbers are not
``jax.random``'s, only its distribution is the reference's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..kernels.policy import resolve_device

__all__ = ["SyntheticLM", "host_shard"]

COPY_LAG = 4
COPY_RATE = 0.35


class SyntheticLM:
    """``(B, S+1)`` token batches, deterministic in ``(seed, step)``.

    Args:
        vocab: Vocabulary size; the Zipf alphabet is ``min(vocab, 4096)``.
        seq_len: S; a batch holds ``S + 1`` tokens a row (inputs and labels).
        global_batch: B.
        seed: The stream's seed.
        structured: Add the copy structure.
        device: Where the batches go; None means the card.

    Example:
        >>> d = SyntheticLM(1000, 16, 2, seed=3, device="cpu")
        >>> d.batch_at(5)["tokens"].shape
        torch.Size([2, 17])
        >>> bool((d.batch_at(5)["tokens"] == d.batch_at(5)["tokens"]).all())
        True
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                 structured: bool = True, device=None):
        self.vocab = vocab
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.structured = structured
        self.device = resolve_device(device)
        # Zipf weights over a capped alphabet for speed
        self._alpha = min(vocab, 4096)
        w = 1.0 / np.arange(1, self._alpha + 1) ** 1.1
        self._probs = torch.from_numpy(w / w.sum()).to(torch.float32)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """``{"tokens": (B, S+1) int64}`` on the device for ``step``."""
        # the CPU generator keeps 32 bits of a seed: mix (seed, step) into them
        g = torch.Generator().manual_seed(
            int(np.random.SeedSequence([self.seed, step]).generate_state(1)[0]))
        shape = (self.batch, self.seq + 1)
        toks = torch.multinomial(self._probs, shape[0] * shape[1], replacement=True,
                                 generator=g).reshape(shape)
        if self.structured:
            # token[t] = token[t-4] on a mask: a learnable 4-gram dependency
            mask = torch.rand(shape, generator=g) < COPY_RATE
            toks = torch.where(mask, torch.roll(toks, COPY_LAG, dims=1), toks)
        return {"tokens": toks.to(self.device)}


def host_shard(batch: Dict[str, torch.Tensor], host_index: int,
               n_hosts: int) -> Dict[str, torch.Tensor]:
    """The rows of the global batch that host ``host_index`` of
    ``n_hosts`` loads.

    Example:
        >>> b = {"tokens": torch.arange(8).reshape(4, 2)}
        >>> host_shard(b, 1, 2)["tokens"].tolist()
        [[4, 5], [6, 7]]
    """
    def rows(x):
        per = x.shape[0] // n_hosts
        return x[host_index * per:(host_index + 1) * per]

    return {k: rows(v) for k, v in batch.items()}
