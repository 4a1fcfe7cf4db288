"""Deterministic synthetic data pipeline with exact-resume semantics, and
Hilbert-ordered token batching (paper §6.2 application note).

The JAX package's pipeline, numpy only and copied: every batch is a pure
function of (seed, step, shard), so a restarted run resumes at any step
bit-identically (no loader state to checkpoint).  Tokens follow a
uniform draw with an induced bigram rule (x[t+1] = (7 x[t] + 13) mod V
for ~70 % of positions), so the LM loss can fall.  ``hilbert_order``
reorders a batch's rows by the Hilbert key of a per-row token sketch
(:func:`hilbert_token_order`, also the serving engine's
``hilbert_admission``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import hilbert_encode_nd


def hilbert_token_order(
    tokens: np.ndarray, *, ndim: int = 3, nbits: int = 6
) -> np.ndarray:
    """Permutation ordering batch rows by a d-dim Hilbert key.

    Each row's sketch is the mean token id over ``ndim`` equal sequence
    chunks, min-max quantised to ``nbits`` bits per axis; rows are sorted
    by the canonical d-dimensional Hilbert order value of the sketch.
    Deterministic (stable sort of a pure function of ``tokens``).
    """
    B, S = tokens.shape
    ndim = max(1, min(ndim, S))
    chunks = np.array_split(tokens.astype(np.float64), ndim, axis=1)
    feat = np.stack([c.mean(axis=1) for c in chunks], axis=1)  # (B, ndim)
    lo = feat.min(axis=0)
    span = np.maximum(feat.max(axis=0) - lo, 1e-9)
    q = ((feat - lo) / span * ((1 << nbits) - 1)).astype(np.int64)
    key = np.asarray(hilbert_encode_nd(q, nbits))
    return np.argsort(key, kind="stable")


def _batch_rng(seed: int, step: int, shard: int) -> np.random.Generator:
    # SeedSequence gives independent streams per (seed, step, shard)
    return np.random.default_rng(np.random.SeedSequence([seed, step, shard]))


def make_batch(
    vocab: int,
    batch: int,
    seq: int,
    *,
    seed: int = 0,
    step: int = 0,
    shard: int = 0,
    embed_dim: int | None = None,
) -> dict[str, np.ndarray]:
    """One shard-local batch: tokens and labels int32 (labels the next
    token, the last one −1: masked); with ``embed_dim`` also embeds f32
    (B, S, embed_dim)."""
    rng = _batch_rng(seed, step, shard)
    base = rng.integers(0, vocab, size=(batch, seq), dtype=np.int64)
    follow = (base * 7 + 13) % vocab
    use = rng.uniform(size=(batch, seq)) < 0.7
    toks = np.where(use, np.roll(follow, 1, axis=1), base)
    toks[:, 0] = base[:, 0]
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    out = {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}
    if embed_dim is not None:
        out["embeds"] = rng.normal(size=(batch, seq, embed_dim)).astype(np.float32)
    return out


@dataclasses.dataclass
class SyntheticPipeline:
    vocab: int
    global_batch: int
    seq: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0
    embed_dim: int | None = None
    embeds_only: bool = False
    hilbert_order: bool = False

    @property
    def shard_batch(self) -> int:
        if self.global_batch % self.num_shards:
            raise ValueError(f"global_batch {self.global_batch} does not split into {self.num_shards} shards")
        return self.global_batch // self.num_shards

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        out = make_batch(self.vocab, self.shard_batch, self.seq, seed=self.seed, step=step,
                         shard=self.shard, embed_dim=self.embed_dim)
        if self.hilbert_order:
            perm = hilbert_token_order(out["tokens"])
            out = {k: v[perm] for k, v in out.items()}
        if self.embeds_only:
            out.pop("tokens")
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
