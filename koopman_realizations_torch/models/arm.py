"""Planar N-link arm plant of the port (the parts of ``models/arm.py``
that the closed loop reads): the closed-form inertia/lever tables
(``arm.py:37-53``), the batched SDIRK2 control-period step
(``models/arm_lanes.py``) and the marker outputs (``get_markers`` :253,
``get_y_batch`` :310).

The plain step is many small elementwise launches a control period
(more with ``jac_mode='substep'``: a Jacobian a substep); the JAX package
compiles it into one XLA computation.  On the
card ``Arm.step`` therefore captures one control period, once per batch
width and dtype, in a CUDA graph with static input and output buffers
(``PlantGraph``) and replays it: the same kernels in the same order, so
its result is bitwise the eager step's (``step_eager``).  A failed
capture raises.  On the CPU the step runs eagerly.

Each graph keeps one period's intermediates in a private memory pool,
proportional to the batch width (chip_smoke.py's phase G logs its size at
B=65536 and B=2048).  An arm keeps the graphs of its ``GRAPH_WIDTHS``
most recently stepped widths and drops the oldest beyond them;
``Arm.clear_graphs`` drops them all."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.config import ArmConfig
from koopman_realizations_torch.models.arm_lanes import sdirk2_rows

# captured control periods an arm keeps (the most recently stepped widths)
GRAPH_WIDTHS = 4


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
        # (B, dtype, device) -> the captured control period, the most
        # recently stepped last
        self._graphs: dict = {}

    @property
    def device(self) -> torch.device:
        return self.G.device

    def step(self, X: torch.Tensor, U: torch.Tensor, W: torch.Tensor):
        """One control period Ts, lanes-minor: X (nx, B), U (m, B) in
        original units, W (2, B) loads; on the card a replay of the
        period's CUDA graph for this batch width and dtype (captured at
        its first call, kept among the last ``GRAPH_WIDTHS``), on the CPU
        ``step_eager``."""
        if not X.is_cuda:
            return self.step_eager(X, U, W)
        key = (X.shape[1], X.dtype, X.device)
        graph = self._graphs.pop(key, None)
        if graph is None:
            if len(self._graphs) >= GRAPH_WIDTHS:
                del self._graphs[next(iter(self._graphs))]
            graph = PlantGraph(self, *key)
        self._graphs[key] = graph
        return graph(X, U, W)

    def clear_graphs(self):
        """Drop every captured control period (and its memory pool)."""
        self._graphs.clear()

    def step_eager(self, X: torch.Tensor, U: torch.Tensor,
                   W: torch.Tensor):
        """``step`` as eager PyTorch operations (the plain plant)."""
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


class PlantGraph:
    """One control period of ``Arm.step_eager`` at batch width B, captured
    in a ``torch.cuda.CUDAGraph``: static inputs X (nx, B), U (m, B),
    W (2, B) and the static output; a call copies its operands into the
    inputs, replays the graph and returns a copy of the output (the next
    replay overwrites it)."""

    def __init__(self, arm: Arm, B: int, dtype: torch.dtype,
                 device: torch.device):
        cfg = arm.cfg
        z = lambda r: torch.zeros((r, B), dtype=dtype, device=device)
        self.X, self.U, self.W = z(cfg.nx), z(cfg.Nmods), z(2)
        # warm up on a side stream (the caching allocator's blocks and
        # any lazy initialisation), then capture
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            arm.step_eager(self.X, self.U, self.W)
        cur.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = arm.step_eager(self.X, self.U, self.W)

    def __call__(self, X, U, W) -> torch.Tensor:
        self.X.copy_(X)
        self.U.copy_(U)
        self.W.copy_(W)
        self.graph.replay()
        return self.out.clone()
