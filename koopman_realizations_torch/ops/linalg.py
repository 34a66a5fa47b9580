"""Dense linear algebra of training (port of ``ops/linalg.py:16-71`` of the
JAX package: PCA, in f64 on the caller's device, and the real matrix
logarithm of continuous-time training, on the host).

``thin_svd`` is the economy SVD under PCA and least squares: a tall matrix
goes through its Householder QR first, then the SVD of the small square R
(on CUDA by cuSOLVER's QR-iteration ``gesvd``).
"""

from __future__ import annotations

import numpy as np
import torch


def thin_svd(A: torch.Tensor):
    """(U, s, Vh) of the economy SVD of A (r, c), s descending."""
    driver = "gesvd" if A.is_cuda else None
    if A.shape[0] > A.shape[1]:
        Q, R = torch.linalg.qr(A)
        Ur, s, Vh = torch.linalg.svd(R, full_matrices=False, driver=driver)
        return Q @ Ur, s, Vh
    return torch.linalg.svd(A, full_matrices=False, driver=driver)


def pca_explained(X: torch.Tensor):
    """Principal components and explained-variance percentages of the rows
    of X, as MATLAB ``pca`` (``Ksysid.m:1498``): centered data, economy
    SVD, loadings as columns.  f64 on X's device; returns (coeffs [d, d],
    explained [d])."""
    X = X.to(torch.float64)
    Xc = X - X.mean(dim=0, keepdim=True)
    _, s, Vh = thin_svd(Xc)
    var = s ** 2
    return Vh.mT, 100.0 * var / var.sum()


def pcs_for_explained(X: torch.Tensor, threshold: float = 99.0):
    """The first principal components of X's rows that explain
    ``threshold`` % of its variance (``Ksysid.get_econ_observables:
    1498-1507``: the smallest k with cumulative explained >= threshold):
    (d, k), f64 on X's device."""
    coeffs, explained = pca_explained(X)
    cum = torch.cumsum(explained, dim=0)
    k = int(torch.searchsorted(
        cum, torch.tensor([threshold], dtype=cum.dtype,
                          device=cum.device)).item()) + 1
    return coeffs[:, :min(k, coeffs.shape[1])]


def logm_host(K) -> np.ndarray:
    """Real matrix logarithm on the host in f64 (scipy's Schur-based
    ``logm``; JAX ``logm_host``, ops/linalg.py:62-71): the continuous-time
    models' generator ``logm(K' + 1e-12 I) / Ts`` (``Ksysid.m:1186-1190``),
    formed once at training time."""
    import scipy.linalg

    return np.real(scipy.linalg.logm(np.asarray(K, np.float64)))
