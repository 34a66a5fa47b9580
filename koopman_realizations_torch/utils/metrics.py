"""Closed-loop tracking error of the port's runners."""

from __future__ import annotations

import torch


def lane_tracking_error(Yp: torch.Tensor, ref_y) -> torch.Tensor:
    """Per-lane mean Euclidean tracking error, as ``bench.py:159-165``.

    Yp (B, K-1, nproj) tracked outputs of a runner; ref_y (K', nproj) the
    unscaled reference (K' >= K-1).  Output k is compared with reference
    row k (the horizon is anchored at the current row, and the scale round
    trip of the recorded reference is exact to fp eps).  f32 arithmetic,
    as the bench's.
    """
    K1 = Yp.shape[1]
    R = torch.as_tensor(ref_y, device=Yp.device)[:K1].to(torch.float32)
    d = Yp.to(torch.float32) - R[None]
    return torch.sqrt((d ** 2).sum(-1)).mean(1)
