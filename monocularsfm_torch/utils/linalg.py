"""Batched small-matrix eigh and SVD in slices the card's solvers accept.

cuSOLVER's batched symmetric eigensolver rejects batches of 32768 or more
small matrices (CUSOLVER_STATUS_INVALID_VALUE from its workspace query,
torch 2.11 with CUDA 12.8 on an H100); 16384 works.  Every batched eigh and
SVD of the port goes through these helpers, which cut the flattened batch
into slices of at most `BATCH` matrices and stitch the results back.  On
the CPU the slicing changes nothing but the call count.
"""

from __future__ import annotations

import torch

BATCH = 16384


def _sliced(fn, A: torch.Tensor):
    m, n = A.shape[-2:]
    flat = A.reshape(-1, m, n)
    if flat.shape[0] <= BATCH:
        return fn(flat)
    parts = [fn(flat[s:s + BATCH]) for s in range(0, flat.shape[0], BATCH)]
    return tuple(torch.cat(p) for p in zip(*parts))


def eigh(A: torch.Tensor):
    """(eigenvalues ascending (..., n), eigenvectors (..., n, n)) of a
    batch of symmetric matrices."""
    w, V = _sliced(torch.linalg.eigh, A)
    return w.reshape(A.shape[:-1]), V.reshape(A.shape)


def eigh_vectors(A: torch.Tensor) -> torch.Tensor:
    """Eigenvectors (ascending eigenvalues) of a batch of symmetric
    matrices."""
    return eigh(A)[1]


def svd(A: torch.Tensor):
    """Reduced SVD (U, S, Vh) of a batch of small matrices."""
    m, n = A.shape[-2:]
    k = min(m, n)
    U, S, Vh = _sliced(lambda x: torch.linalg.svd(x, full_matrices=False), A)
    lead = A.shape[:-2]
    return (U.reshape(lead + (m, k)), S.reshape(lead + (k,)),
            Vh.reshape(lead + (k, n)))
