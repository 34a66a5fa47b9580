"""Planar N-link arm plant of the port (the parts of ``models/arm.py``
that the closed loop reads): the closed-form inertia/lever tables
(``arm.py:37-53``), the batched SDIRK2 control-period step
(``models/arm_lanes.py``) and the marker outputs (``get_markers`` :253,
``get_y_batch`` :310)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.config import ArmConfig
from koopman_realizations_torch.models.arm_lanes import sdirk2_rows


def markers_rows(cfg: ArmConfig, a_rows):
    """Outputs as rows from the joint angles a_rows (list of Nlinks rows):
    'angles' as they are; 'markers' the xy of every ``nlinks``-th joint,
    origin dropped, ordered (x_1, y_1, x_2, y_2, ...)."""
    if cfg.output_type == "angles":
        return list(a_rows)
    if cfg.output_type != "markers":
        raise NotImplementedError(f"output_type {cfg.output_type!r}")
    l = cfg.l
    xs, ys = [], []
    th = rx = ry = None
    for a in a_rows:
        th = a if th is None else th + a
        sx = -l * torch.sin(th)
        sy = l * torch.cos(th)
        rx = sx if rx is None else rx + sx
        ry = sy if ry is None else ry + sy
        xs.append(rx)
        ys.append(ry)
    out = []
    for j in range(cfg.nlinks - 1, cfg.Nlinks, cfg.nlinks):
        out += [xs[j], ys[j]]
    return out


class Arm(nn.Module):
    """Planar arm with the closed-form Lagrangian dynamics (SDIRK2 only).

    ``G``/``b`` are registered buffers (f64): the inertia coefficients
    G[p,q] = N - max(p,q) + 1/2 (p != q), G[p,p] = N - p + 1/4 (1-based)
    and the gravity levers b_j = N - j + 1/2.
    """

    def __init__(self, cfg: ArmConfig, device="cuda"):
        super().__init__()
        if cfg.integrator != "sdirk2" or cfg.jac_mode not in ("step",
                                                              "substep"):
            raise NotImplementedError(
                "the port integrates the arm with SDIRK2 jac_mode "
                "'step'/'substep' only")
        self.cfg = cfg
        N = cfg.Nlinks
        idx = np.arange(1, N + 1)
        G = (N - np.maximum(idx[:, None], idx[None, :]) + 0.5).astype(float)
        np.fill_diagonal(G, N - idx + 0.25)
        b = (N - idx + 0.5).astype(float)
        # host copies: the RHS reads them as scalar coefficients
        self.G_host, self.b_host = G, b
        dev = resolve_device(device)
        self.register_buffer("G", torch.as_tensor(G, device=dev))
        self.register_buffer("b", torch.as_tensor(b, device=dev))

    def step(self, X: torch.Tensor, U: torch.Tensor, W: torch.Tensor):
        """One control period Ts, lanes-minor: X (nx, B), U (m, B) in
        original units, W (2, B) loads."""
        cfg = self.cfg
        return torch.stack(sdirk2_rows(
            cfg, self.G_host, self.b_host, tuple(X), list(U), W[0], W[1],
            cfg.Ts, cfg.substeps, cfg.newton_iters, cfg.jac_mode))

    def get_y(self, X: torch.Tensor) -> torch.Tensor:
        """Lanes-minor outputs: X (nx, B) -> (ny, B)."""
        return torch.stack(markers_rows(self.cfg, list(X[:self.cfg.Nlinks])))

    def get_y_batch(self, X) -> torch.Tensor:
        """Row-major outputs as in the JAX package: X (B, nx) -> (B, ny)."""
        X = torch.as_tensor(X, device=self.G.device)
        return self.get_y(X.T).T
