"""Minimum-norm least squares by SVD (port of ``ops/lstsq.py:25-49`` of the
JAX package, without its refinement passes).

``torch.linalg.lstsq`` on CUDA has only the QR driver ``gels``, which
assumes full rank and ignores ``rcond``; lifted dictionaries are routinely
rank-deficient, and the truncation below is what keeps the extracted
models bounded.  So the solve is an explicit SVD in f64 on the device.
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
