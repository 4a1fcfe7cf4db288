"""Hilbert-ordered token batching (paper §6.2 application note).

Only :func:`hilbert_token_order` is in this slice, for the serving
engine's ``hilbert_admission``; the rest of the JAX package's pipeline
(the deterministic synthetic batches) arrives with the training slice.
"""
from __future__ import annotations

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
