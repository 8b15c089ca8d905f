"""PCA-reduced proposal basis.

Equivalent of ``Parameters/PCAHandler.cpp``: the reference
eigen-decomposes a sub-block of the covariance, drops eigenvalues below a
threshold, and walks the chain in the PCA basis with ``TransferToPCA`` /
``TransferToParam`` every step (``PCAHandler.cpp:25-226``).

Here PCA is a *fixed linear reparameterisation folded into the throw matrix*:
proposing with covariance ``T Λ_kept T^T`` is exactly proposing
``theta' = theta + (T sqrt(Λ_kept)) z`` with ``z ~ N(0, I_k)`` — so the whole
handler reduces to a rectangular [P, K] matrix that replaces the Cholesky
factor. No per-step basis transfers, no PCA state.

Parameters outside the decomposed sub-block keep their original (Cholesky)
columns, mirroring the reference's identity blocks around the PCA window
(``PCAHandler.cpp:25-130``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.logging import get_logger

_log = get_logger("pca")


@dataclasses.dataclass
class PCAResult:
    throw_matrix: np.ndarray  # [P, K + outside] rectangular proposal factor
    eigenvalues: np.ndarray  # kept eigenvalues
    transfer: np.ndarray  # [P, K] kept eigenvectors (parameter <- PCA basis)
    n_kept: int
    n_dropped: int
    first: int
    last: int


def construct_pca(
    covariance: np.ndarray,
    threshold: float = 1e-5,
    first: int = 0,
    last: int | None = None,
) -> PCAResult:
    """Build the PCA-reduced throw matrix.

    covariance: full [P, P]; the block [first:last+1] is decomposed; outside
    the block each parameter keeps an independent column with its own sigma
    (the reference's identity blocks).
    """
    p = covariance.shape[0]
    last = p - 1 if last is None else last
    block = covariance[first : last + 1, first : last + 1]
    eigval, eigvec = np.linalg.eigh(block)
    order = np.argsort(eigval)[::-1]
    eigval, eigvec = eigval[order], eigvec[:, order]
    total = eigval.sum()
    keep = eigval > threshold * total
    n_kept = int(keep.sum())
    n_dropped = int((~keep).sum())
    _log.info(
        "PCA: kept %d of %d eigenvalues in block [%d, %d] (threshold %g)",
        n_kept,
        len(eigval),
        first,
        last,
        threshold,
    )

    kept_vec = eigvec[:, keep]  # [B, K]
    kept_val = eigval[keep]

    outside = [i for i in range(p) if i < first or i > last]
    n_cols = n_kept + len(outside)
    throw = np.zeros((p, n_cols))
    # PCA block columns
    throw[first : last + 1, :n_kept] = kept_vec * np.sqrt(kept_val)[None, :]
    # Outside-block columns: Cholesky of the outside sub-covariance keeps any
    # correlations among non-PCA'd parameters.
    if outside:
        sub = covariance[np.ix_(outside, outside)]
        chol = np.linalg.cholesky(sub + 1e-15 * np.eye(len(outside)))
        for col, _ in enumerate(outside):
            throw[outside, n_kept + col] = chol[:, col]

    transfer = np.zeros((p, n_kept))
    transfer[first : last + 1] = kept_vec
    return PCAResult(
        throw_matrix=throw,
        eigenvalues=kept_val,
        transfer=transfer,
        n_kept=n_kept,
        n_dropped=n_dropped,
        first=first,
        last=last,
    )


def to_pca_basis(result: PCAResult, theta_block: np.ndarray) -> np.ndarray:
    """Project parameter-space values into the kept-PCA basis (TransferToPCA)."""
    return result.transfer.T @ theta_block


def from_pca_basis(result: PCAResult, pca_vals: np.ndarray) -> np.ndarray:
    """PCA-basis values back to parameter space (TransferToParam)."""
    return result.transfer @ pca_vals
