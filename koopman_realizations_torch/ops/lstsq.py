"""Least squares (port of ``ops/lstsq.py`` of the JAX package).

- ``lstsq``: minimum-norm solve by SVD (``:25-49``, without its
  refinement passes).  ``torch.linalg.lstsq`` on CUDA has only the QR
  driver ``gels``, which assumes full rank and ignores ``rcond``; lifted
  dictionaries are routinely rank-deficient, and the truncation below is
  what keeps the extracted models bounded.  So the solve is an explicit
  SVD in f64 on the device.
- ``gram_lstsq`` / ``ridge_for_dtype``: the normal equations from Gram
  matrices by Cholesky with a scaled ridge (``:52-78``), batched over
  leading axes (the random-system sweep's system axis).
"""

from __future__ import annotations

from typing import Optional

import torch

from koopman_realizations_torch.ops.linalg import thin_svd


def lstsq(A: torch.Tensor, B: torch.Tensor,
          rcond: Optional[float] = None) -> torch.Tensor:
    """X = argmin ||A X - B||_F of least norm, in f64 on A's device.

    Singular values s <= rcond * s_max count as zero (numpy ``lstsq``'s
    cutoff); the default rcond is eps64 * max(A.shape), the JAX
    ``lstsq``'s for an f64 A.
    """
    A = A.to(torch.float64)
    B = B.to(device=A.device, dtype=torch.float64)
    U, s, Vh = thin_svd(A)
    if rcond is None:
        rcond = torch.finfo(torch.float64).eps * max(A.shape)
    s_inv = torch.where(s > rcond * s[0], 1.0 / s, torch.zeros_like(s))
    return Vh.mT @ (s_inv[:, None] * (U.mT @ B))


def gram_lstsq(AtA: torch.Tensor, AtB: torch.Tensor, ridge: float = 0.0,
               psum_axis: Optional[str] = None) -> torch.Tensor:
    """Solve (AtA) X = AtB by Cholesky with a diagonal ridge scaled by
    max(tr(AtA) / n, 1), then two triangular solves (``gram_lstsq`` of
    ``ops/lstsq.py:52-69``), batched over any leading axes, in AtA's dtype
    on its device."""
    if psum_axis is not None:
        raise NotImplementedError(
            "psum_axis (Gram blocks summed across devices) is not ported "
            "(ROADMAP.md queue 1, item 9)")
    n = AtA.shape[-1]
    eye = torch.eye(n, dtype=AtA.dtype, device=AtA.device)
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr / n, min=1.0)[..., None, None]
    Lc = torch.linalg.cholesky(AtA + (ridge * scale) * eye)
    Y = torch.linalg.solve_triangular(Lc, AtB, upper=False)
    return torch.linalg.solve_triangular(Lc.mT, Y, upper=True)


def ridge_for_dtype(dtype) -> float:
    """The normal equations' default jitter: 1e-12 in f64, 1e-6 otherwise
    (``ops/lstsq.py:72-78``)."""
    return 1e-12 if dtype == torch.float64 else 1e-6
