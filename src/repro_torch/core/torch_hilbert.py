"""Device-side Hilbert coding: the Mealy automaton as vectorised torch ops.

The paper's automaton (§3) processes bit-pairs sequentially; here the
same tables run as a Python loop over the (static) bit levels, with the
whole coordinate *vector* processed in parallel per level — one handful of
int32 tensor ops per level, no per-point loop.  Used for Hilbert-ordered
point batching (k-means, ε-join); host-side schedule generation uses the
numpy twin in :mod:`repro_torch.core.hilbert` (bit-identical, asserted in
tests).  Everything stays int32, with the same overflow rules as the
numpy codecs: ``d * nbits <= 31``.
"""
from __future__ import annotations

import functools

import torch

from .hilbert import _ENC_DIGIT, _ENC_NEXT, U


@functools.lru_cache(maxsize=16)
def _enc_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Flattened [state * 4 + quadrant] encode tables on ``device``."""
    digit = torch.as_tensor(_ENC_DIGIT.reshape(-1), dtype=torch.int32, device=device)
    nxt = torch.as_tensor(_ENC_NEXT.reshape(-1), dtype=torch.int32, device=device)
    return digit, nxt


def hilbert_encode_torch(i: torch.Tensor, j: torch.Tensor, nbits: int) -> torch.Tensor:
    """h = H(i, j) for integer tensors; ``nbits`` bit-pair levels.

    ``nbits`` is rounded up to even inside (paper §3 parity rule); order
    values are int32, so 2*nbits <= 31 keeps them exact.
    """
    nbits = nbits + (nbits & 1)
    i = i.to(torch.int32)
    j = j.to(torch.int32)
    shape = torch.broadcast_shapes(i.shape, j.shape)
    enc_digit, enc_next = _enc_tables(i.device)
    state = torch.full(shape, U, dtype=torch.int32, device=i.device)
    h = torch.zeros(shape, dtype=torch.int32, device=i.device)
    for t in range(nbits):
        level = nbits - 1 - t
        q = ((i >> level) & 1) * 2 + ((j >> level) & 1)
        idx = (state * 4 + q).long()
        h = (h << 2) | enc_digit[idx]
        state = enc_next[idx]
    return h


def hilbert_encode_nd_torch(coords: torch.Tensor, nbits: int) -> torch.Tensor:
    """h = H_d(coords) for integer coords[..., d] — the device twin of
    :func:`repro_torch.core.hilbert_nd.hilbert_encode_nd` (bit-identical,
    asserted in tests).

    The Butz/Lawder rotate-reflect transform runs level by level over the
    (static) bit levels with the axis loop unrolled — the whole
    coordinate batch is processed in parallel per level.  ``nbits`` is
    rounded up to a multiple of d (canonical resolution-free coding);
    requires d * nbits <= 31 for int32 order values.
    """
    ndim = coords.shape[-1]
    nbits = nbits + (-nbits) % ndim
    if nbits * ndim > 31:
        raise ValueError(f"nbits*ndim = {nbits * ndim} > 31 overflows int32")
    X = [coords[..., k].to(torch.int32) for k in range(ndim)]
    for t in range(nbits - 1):
        # Q = M >> t, top-down rotate-reflect
        Q = 1 << (nbits - 1 - t)
        P = Q - 1
        for k in range(ndim):
            hi = (X[k] & Q) != 0
            if k == 0:  # swap term is identically 0 for the pivot axis
                X[0] = torch.where(hi, X[0] ^ P, X[0])
            else:
                swap = (X[0] ^ X[k]) & P
                X[0], X[k] = (
                    torch.where(hi, X[0] ^ P, X[0] ^ swap),
                    torch.where(hi, X[k], X[k] ^ swap),
                )
    for k in range(1, ndim):
        X[k] = X[k] ^ X[k - 1]
    tacc = torch.zeros_like(X[0])
    for t in range(nbits - 1):
        Q = 1 << (nbits - 1 - t)
        tacc = torch.where((X[ndim - 1] & Q) != 0, tacc ^ (Q - 1), tacc)
    X = [x ^ tacc for x in X]
    h = torch.zeros_like(X[0])
    for b in range(nbits):
        level = nbits - 1 - b
        for k in range(ndim):
            h = (h << 1) | ((X[k] >> level) & 1)
    return h


def hilbert_sort_key(coords: torch.Tensor, nbits: int) -> torch.Tensor:
    """Hilbert keys for int coordinate tuples coords[..., d] (locality-
    preserving point batching — paper §6.2 application note,
    d-dimensional).  d = 2 routes through the Mealy-automaton codec
    (bit-identical to the nd codec; both canonicalise nbits)."""
    if coords.shape[-1] == 2:
        return hilbert_encode_torch(coords[..., 0], coords[..., 1], nbits)
    return hilbert_encode_nd_torch(coords, nbits)
