"""Planar N-link arm plant of the port (JAX ``models/arm.py``): the
kinematics, the Lagrangian dynamics by autodiff (``mass_matrix``,
``accel``, ``rhs``; ``torch.func``) and in closed form
(``models/arm_lanes.py``), the control period with every integrator of
``ArmConfig`` (``step``), the four outputs and data generation
(``ramp_and_hold``, ``simulate``, ``simulate_rampNhold`` and
``simulate_rampNhold_batch``).

The control period is lanes-minor: X (nx, B), one column a lane.  SDIRK2
with ``jac_mode`` 'step' or 'substep' is ``arm_lanes.sdirk2_rows`` (the
fused step kernels' plant); 'stage', 'rk4' and 'rk45' integrate
``arm_lanes.rhs_lanes``, the same closed form on stacked tensors, with
``ops/integrators.py`` ('stage' with the Jacobian of ``arm_lanes``'
dual numbers).  The JAX lane path integrates the autodiff RHS there; the
two agree to rounding (``tests/test_torch_arm_full.py``).

The plain period is many small elementwise launches; the JAX package
compiles it into one XLA computation.  On the card ``Arm.step`` therefore
captures one control period, once per batch width and dtype, in a CUDA
graph with static input and output buffers (``PlantGraph``) and replays
it: the same kernels in the same order, so its result is bitwise the
eager step's (``step_eager``).  'rk45' runs as many iterations as its
slowest lane needs, which one graph cannot hold: ``RK45Graph`` captures a
fixed chunk of masked Dormand-Prince iterations and replays it until no
lane is active (a finished lane's iterations change nothing, so this too
is bitwise the eager loop).  A failed capture raises.  On the CPU the step
runs eagerly.

Each graph keeps one period's intermediates in a private memory pool,
proportional to the batch width (chip_smoke.py's phases G and GN log its
size).  An arm keeps the graphs of its ``GRAPH_WIDTHS`` most recently
stepped widths and drops the oldest beyond them; ``Arm.clear_graphs``
drops them all."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.config import ArmConfig
from koopman_realizations_torch.models.arm_lanes import (
    LaneLoads,
    LaneTables,
    jacobian_rows,
    make_rhs_tuple,
    rhs_lanes,
    sdirk2_rows,
)
from koopman_realizations_torch.ops import integrators as I
from koopman_realizations_torch.ops.batch_linalg import solve_spd_unrolled

# captured control periods an arm keeps (the most recently stepped widths)
GRAPH_WIDTHS = 4
# masked Dormand-Prince iterations in one replay of an RK45Graph
RK45_CHUNK = 8

INTEGRATORS = ("sdirk2", "rk4", "rk45")
JAC_MODES = ("step", "substep", "stage")
OUTPUTS = ("angles", "markers", "endeff", "shape")


def shape_obs_matrix(cfg: ArmConfig) -> np.ndarray:
    """pinv of the degree-3 Vandermonde system of ``points2poly``
    (``Arm.m:339-352``): (3, Nmods + 3), static in the marker positions."""
    positions = np.asarray(cfg.markerPos)[1:]
    supp = np.concatenate([[0.0, 1e-2], positions, [1.0 + 1e-2]])
    return np.linalg.pinv(np.stack([supp ** i for i in range(1, 4)], 1))


def output_rows(cfg: ArmConfig, a_rows, P=None):
    """Outputs as rows from the joint angles a_rows (list of Nlinks rows,
    each (B,) or 0-d): 'angles' as they are; 'markers' the xy of every
    ``nlinks``-th joint, origin dropped, ordered (x_1, y_1, x_2, y_2,
    ...); 'endeff' the last marker; 'shape' the degree-3 shape
    polynomial's coefficients (cx1, cx2, cx3, cy1, cy2, cy3) through the
    origin, the support point (0, 1e-2), the markers and a point 1e-2
    past the end along [sin, cos] of the last link's absolute angle (the
    reference's ``theta2complex`` quirk, JAX ``arm.py:273-280``), with
    ``P`` = ``shape_obs_matrix(cfg)`` as a tensor."""
    ot = cfg.output_type
    if ot == "angles":
        return list(a_rows)
    if ot not in OUTPUTS:
        raise ValueError(f"unknown output_type {ot!r}")
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
    marks = [(xs[j], ys[j])
             for j in range(cfg.nlinks - 1, cfg.Nlinks, cfg.nlinks)]
    if ot == "markers":
        return [v for xy in marks for v in xy]
    if ot == "endeff":
        return list(marks[-1])
    zero = torch.zeros_like(th)
    ex = torch.sin(th) * 1e-2 + marks[-1][0]
    ey = torch.cos(th) * 1e-2 + marks[-1][1]
    px = torch.stack([zero, zero] + [x for x, _ in marks] + [ex])
    py = torch.stack([zero, zero + 1e-2] + [y for _, y in marks] + [ey])
    P = P.to(px.dtype)
    return list(P @ px) + list(P @ py)


class Arm(nn.Module):
    """Planar arm with Lagrangian dynamics, on ``device``.

    ``G``/``b`` are registered buffers (f64): the inertia coefficients
    G[p,q] = N - max(p,q) + 1/2 (p != q), G[p,p] = N - p + 1/4 (1-based)
    and the gravity levers b_j = N - j + 1/2; ``P`` the shape fit's
    pseudo-inverse (``shape_obs_matrix``).
    """

    def __init__(self, cfg: ArmConfig, device="cuda"):
        super().__init__()
        if cfg.integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {cfg.integrator!r}")
        if cfg.integrator == "sdirk2" and cfg.jac_mode not in JAC_MODES:
            raise ValueError(f"unknown jac_mode {cfg.jac_mode!r}")
        if cfg.output_type not in OUTPUTS:
            raise ValueError(f"unknown output_type {cfg.output_type!r}")
        self.cfg = cfg
        self.nlinks = cfg.Nlinks
        N = cfg.Nlinks
        idx = np.arange(1, N + 1)
        G = (N - np.maximum(idx[:, None], idx[None, :]) + 0.5).astype(float)
        np.fill_diagonal(G, N - idx + 0.25)
        b = (N - idx + 0.5).astype(float)
        # host copies: the RHS reads them as scalar coefficients
        self.G_host, self.b_host = G, b
        self._shape_obs_matrix = shape_obs_matrix(cfg)
        dev = resolve_device(device)
        self.register_buffer("G", torch.as_tensor(G, device=dev))
        self.register_buffer("b", torch.as_tensor(b, device=dev))
        self.register_buffer("P", torch.as_tensor(self._shape_obs_matrix,
                                                  device=dev))
        # (B, dtype, device) -> the captured control period, the most
        # recently stepped last
        self._graphs: dict = {}
        self._tables: dict = {}

    @property
    def device(self) -> torch.device:
        return self.G.device

    # ---------------------------------------------------------- kinematics

    def alpha2theta(self, alpha):
        """Relative joint angles -> absolute angles (``Arm.m:37-50``)."""
        return torch.cumsum(alpha, -1)

    def joint_positions(self, alpha):
        """xy of each joint 0..Nlinks (rows) and the link COMs
        (``Arm.m:53-76``) of one lane's angles alpha (Nlinks,)."""
        theta = self.alpha2theta(alpha)
        step = self.cfg.l * torch.stack([-torch.sin(theta),
                                         torch.cos(theta)], 1)
        joints = torch.cat([alpha.new_zeros((1, 2)),
                            torch.cumsum(step, 0)], 0)
        return joints, joints[:-1] + 0.5 * step

    # ------------------------------------------------------------ dynamics

    def mass_matrix(self, alpha, w):
        """Dq of one lane (``Arm.m:148-151``), closed form: J^T M_theta J
        with J the lower-triangular ones and M_theta[p,q] = l^2 (m G[p,q]
        + w1) cos(th_p - th_q) + i delta_pq."""
        cfg = self.cfg
        theta = self.alpha2theta(alpha)
        coef = cfg.l ** 2 * (cfg.m * self.G.to(alpha.dtype) + w[0])
        M_th = coef * torch.cos(theta[:, None] - theta[None, :]) \
            + cfg.i * torch.eye(self.nlinks, dtype=alpha.dtype,
                                device=alpha.device)
        tmp = torch.cumsum(M_th.flip(0), 0).flip(0)        # J^T M
        return torch.cumsum(tmp.flip(1), 1).flip(1)        # (J^T M) J

    def _mass_matrix_autodiff(self, alpha, w):
        """Dq from the reference's Jacobian products (kept to validate
        ``mass_matrix``): m Jxcm^T Jxcm + i Jth^T Jth + Jx^T diag(m_eff)
        Jx, the load mass on the last joint."""
        cfg = self.cfg
        jac = torch.func.jacfwd
        J_xcm = jac(lambda a: self.joint_positions(a)[1].reshape(-1))(alpha)
        J_th = jac(self.alpha2theta)(alpha)
        J_x = jac(lambda a: self.joint_positions(a)[0][1:].reshape(-1))(
            alpha)
        m_joints = torch.cat([alpha.new_zeros(2 * self.nlinks - 2),
                              w[0] * alpha.new_ones(2)])
        return (cfg.m * J_xcm.T @ J_xcm + cfg.i * J_th.T @ J_th
                + J_x.T @ (m_joints[:, None] * J_x))

    def potential_energy(self, alpha, w):
        """PE with tilted gravity and joint springs (``Arm.m:164-169``)."""
        cfg = self.cfg
        theta = self.alpha2theta(alpha)
        lever = cfg.m * self.b.to(alpha.dtype) + w[0]
        h = cfg.l * torch.sum(lever * torch.cos(theta - w[1]))
        return -cfg.g * h + 0.5 * cfg.k * torch.sum(alpha ** 2)

    def input_torque(self, alpha, u):
        """tau = -ku (kron(u, 1_nlinks) - alpha) (``Arm.m:211-213``)."""
        return -self.cfg.ku * (
            torch.repeat_interleave(u, self.cfg.nlinks) - alpha)

    def accel(self, alpha, alphadot, u, w):
        """One lane's joint accelerations from the Euler-Lagrange
        equations (``Arm.set_EOM:220-221``): Dq addot = -(Dq_dt adot -
        dL/da + d adot + tau), dL/da by ``torch.func.grad`` and Dq_dt by
        ``torch.func.jacfwd`` of the mass matrix."""
        cfg = self.cfg

        def lagrangian(a):
            ke = 0.5 * alphadot @ (self.mass_matrix(a, w) @ alphadot)
            return ke - self.potential_energy(a, w)

        dLda = torch.func.grad(lagrangian)(alpha)
        dDq = torch.func.jacfwd(lambda a: self.mass_matrix(a, w))(alpha)
        Dq_dt = torch.einsum("ijk,k->ij", dDq, alphadot)
        non_inert = (Dq_dt @ alphadot - dLda + cfg.d * alphadot
                     + self.input_torque(alpha, u))
        return solve_spd_unrolled(self.mass_matrix(alpha, w), -non_inert)

    def rhs(self, x, u, w):
        """One lane's RHS for x = [alpha; alphadot] (``Arm.vf_RHS``)."""
        n = self.nlinks
        return torch.cat([x[n:], self.accel(x[:n], x[n:], u, w)])

    # ---------------------------------------------------------- simulation

    def tables(self, dtype, device) -> LaneTables:
        """``rhs_lanes``' constants in ``dtype`` on ``device`` (made once,
        outside any graph capture: the capture's warm-up call makes
        them)."""
        key = (dtype, device)
        if key not in self._tables:
            self._tables[key] = LaneTables(self.cfg, self.G_host,
                                           self.b_host, dtype, device)
        return self._tables[key]

    def lane_rhs(self, U, W):
        """f(X) = dX/dt (nx, B) of every lane under inputs U (m, B) and
        loads W (2, B): ``rhs_lanes``, the period's fixed terms made
        once."""
        loads = LaneLoads(self.cfg, self.tables(U.dtype, U.device), U,
                          W[0], W[1])
        return lambda X: rhs_lanes(self.cfg, loads, X)

    def lane_jacobian(self, U, W):
        """J(X) (nx, nx, B) of ``lane_rhs``' f: one forward pass of
        ``arm_lanes``' dual numbers through ``rhs_soa`` (which the host
        dispatches faster than ``torch.func`` forward mode over
        ``rhs_lanes``)."""
        f = make_rhs_tuple(self.cfg, self.G_host, self.b_host, list(U),
                           W[0], W[1])
        return lambda X: torch.stack([torch.stack(r) for r in
                                      jacobian_rows(f, tuple(X))])

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
            cls = RK45Graph if self.cfg.integrator == "rk45" else PlantGraph
            graph = cls(self, *key)
        self._graphs[key] = graph
        return graph(X, U, W)

    def clear_graphs(self):
        """Drop every captured control period (and its memory pool)."""
        self._graphs.clear()

    def step_eager(self, X: torch.Tensor, U: torch.Tensor,
                   W: torch.Tensor):
        """``step`` as eager PyTorch operations (the plain plant)."""
        cfg = self.cfg
        if cfg.integrator == "sdirk2" and cfg.jac_mode != "stage":
            return torch.stack(sdirk2_rows(
                cfg, self.G_host, self.b_host, tuple(X), list(U), W[0],
                W[1], cfg.Ts, cfg.substeps, cfg.newton_iters, cfg.jac_mode))
        f = self.lane_rhs(U, W)
        if cfg.integrator == "rk4":
            return I.rk4(f, X, cfg.Ts, cfg.substeps)
        if cfg.integrator == "rk45":
            return I.rk45(f, X, cfg.Ts)
        return I.sdirk2(f, X, cfg.Ts, cfg.substeps, cfg.newton_iters,
                        "stage", jac=self.lane_jacobian(U, W))

    def simulate_Ts(self, x, u, w=None):
        """One lane's control period (``Arm.simulate_Ts:932-956``): x (nx,),
        u (m,), w (2,) (default no load) -> x (nx,)."""
        w = x.new_zeros(2) if w is None else torch.as_tensor(
            w, dtype=x.dtype, device=x.device)
        u = torch.as_tensor(u, dtype=x.dtype, device=x.device)
        return self.step(x[:, None], u[:, None], w[:, None])[:, 0]

    def simulate(self, x0, U, w=None):
        """Roll the plant over a ZOH input table U [T, nu] from x0 (nx,):
        X [T+1, nx], ``U[k]`` held over step k."""
        x0 = torch.as_tensor(x0, device=self.device)
        U = torch.as_tensor(U, dtype=x0.dtype, device=self.device)
        w = x0.new_zeros(2) if w is None else torch.as_tensor(
            w, dtype=x0.dtype, device=self.device)
        return self._roll(x0[:, None], U[:, :, None], w[:, None])[:, :, 0]

    def _roll(self, X0, U, W):
        """(T+1, nx, B) states from X0 (nx, B) under inputs U (T, m, B)."""
        X = torch.empty((U.shape[0] + 1,) + X0.shape, dtype=X0.dtype,
                        device=X0.device)
        X[0] = X0
        for k in range(U.shape[0]):
            X[k + 1] = self.step(X[k], U[k], W)
        return X

    def ramp_and_hold(self, rng: np.random.Generator, tf: float,
                      Tramp: float):
        """Random ramp-and-hold input table (``Arm.get_rampNhold:
        1054-1070``), host numpy: (tsteps [T], u [T, nu])."""
        cfg = self.cfg
        tsteps = np.arange(0.0, tf + 1e-12, cfg.Ts)
        tswitch = np.arange(0.0, tf + 1e-12, Tramp)
        num_periods = int(np.ceil(len(tswitch) / 2))
        vals = cfg.umax * (2 * rng.random((num_periods, cfg.Nmods)) - 1)
        hold = np.repeat(vals, 2, axis=0)[: len(tswitch)]
        u = np.stack([np.interp(tsteps, tswitch, hold[:, j], left=0,
                                right=0) for j in range(cfg.Nmods)], axis=1)
        return tsteps, u

    # -------------------------------------------------------------- sensing

    def get_markers(self, alpha):
        """One lane's marker xy rows: every nlinks-th joint, the origin
        first (``Arm.get_markers:307-311``)."""
        return self.joint_positions(alpha)[0][:: self.cfg.nlinks]

    def shape_coeffs(self, alpha):
        """One lane's degree-3 shape coefficients [cx1 cx2 cx3 cy1 cy2
        cy3] (``Arm.points2poly:314-361``)."""
        cfg = dataclasses.replace(self.cfg, output_type="shape")
        return torch.stack(output_rows(cfg, list(alpha), self.P))

    def shape_curve(self, alpha, n_pts: int = 101):
        """The fitted shape polynomial at n_pts points of [0, 1]
        (``Arm.get_shape:415-432``): (n_pts, 2) xy samples."""
        coeffs = self.shape_coeffs(alpha).reshape(2, 3)
        s = torch.linspace(0.0, 1.0, n_pts, dtype=alpha.dtype,
                           device=alpha.device)
        return (coeffs @ torch.stack([s, s ** 2, s ** 3])).T

    def get_y(self, X: torch.Tensor) -> torch.Tensor:
        """Lanes-minor outputs: X (nx, B) -> (ny, B), or one lane's
        x (nx,) -> (ny,) (``Arm.get_y:364-412``)."""
        return torch.stack(output_rows(self.cfg, list(X[:self.cfg.Nlinks]),
                                       self.P))

    def get_y_batch(self, X) -> torch.Tensor:
        """Row-major outputs as in the JAX package: X (B, nx) -> (B, ny)."""
        X = torch.as_tensor(X, device=self.G.device)
        return self.get_y(X.T).T

    # ------------------------------------------------------ data generation

    def simulate_rampNhold_batch(self, rng: np.random.Generator, tf: float,
                                 Tramp: float, W: np.ndarray,
                                 dtype=torch.float64) -> list:
        """Batched excitation trials (JAX ``arm.py:315-344``): one
        ramp-and-hold table a trial, drawn from ``rng`` in the JAX
        package's order, all B trials stepped together from rest under
        their loads W (B, 2), in ``dtype`` on the arm's device.  A list of
        B sim dicts (t, x, alpha, alphadot, y, u, w; host numpy), each
        x with T rows including x0 under the table's first T-1 rows."""
        W = np.asarray(W, float)
        B = W.shape[0]
        tables = [self.ramp_and_hold(rng, tf, Tramp) for _ in range(B)]
        t = tables[0][0]
        U = np.stack([u for _, u in tables])              # (B, T, nu)
        dev = self.device
        Ut = torch.as_tensor(U[:, :-1], dtype=dtype, device=dev).permute(
            1, 2, 0).contiguous()
        Wt = torch.as_tensor(W.T, dtype=dtype, device=dev).contiguous()
        X = self._roll(torch.zeros((self.cfg.nx, B), dtype=dtype,
                                   device=dev), Ut, Wt)   # (T, nx, B)
        T = X.shape[0]
        Y = self.get_y(X.permute(1, 0, 2).reshape(self.cfg.nx, T * B))
        Y = Y.reshape(-1, T, B).permute(2, 1, 0).cpu().numpy()
        X = X.permute(2, 0, 1).cpu().numpy()
        N = self.nlinks
        return [{"t": t, "x": X[b], "alpha": X[b][:, :N],
                 "alphadot": X[b][:, N:], "y": Y[b], "u": U[b],
                 "w": np.tile(W[b], (len(t), 1))} for b in range(B)]

    def simulate_rampNhold(self, rng: np.random.Generator, tf: float,
                           Tramp: float, w=np.zeros(2),
                           dtype=torch.float64) -> dict:
        """One excitation trial (``Arm.simulate_rampNhold:866-929``): the
        sim dict (t, x, alpha, alphadot, y, u, w) of ``simulate`` under a
        fresh ramp-and-hold table."""
        t, u = self.ramp_and_hold(rng, tf, Tramp)
        x0 = torch.zeros(self.cfg.nx, dtype=dtype, device=self.device)
        X = self.simulate(x0, u[:-1], w)
        Y = self.get_y_batch(X).cpu().numpy()
        X = X.cpu().numpy()
        N = self.nlinks
        return {"t": t, "x": X, "alpha": X[:, :N], "alphadot": X[:, N:],
                "y": Y, "u": u, "w": np.tile(np.asarray(w), (len(t), 1))}


def _capture(fn, warmup, device):
    """Warm ``warmup`` up on a side stream (the caching allocator's blocks
    and any lazy initialisation), then capture ``fn`` in a CUDA graph:
    (graph, fn's output)."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        warmup()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


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
        period = lambda: arm.step_eager(self.X, self.U, self.W)
        self.graph, self.out = _capture(period, period, device)

    def __call__(self, X, U, W) -> torch.Tensor:
        self.X.copy_(X)
        self.U.copy_(U)
        self.W.copy_(W)
        self.graph.replay()
        return self.out.clone()


class RK45Graph:
    """A control period of the 'rk45' plant at batch width B: a CUDA graph
    of ``RK45_CHUNK`` masked Dormand-Prince iterations
    (``integrators.rk45_iteration``) on static state buffers (t, x, h,
    count), replayed until no lane is active (one host check a replay).
    Iterations past a lane's end leave it exactly as it was, so the result
    is bitwise ``Arm.step_eager``'s."""

    def __init__(self, arm: Arm, B: int, dtype: torch.dtype,
                 device: torch.device):
        cfg = arm.cfg
        self.T = cfg.Ts
        z = lambda r: torch.zeros((r, B), dtype=dtype, device=device)
        self.U, self.W = z(cfg.Nmods), z(2)
        self.state = I.rk45_start(z(cfg.nx), self.T)

        def chunk():
            # the period's fixed terms from the static U, W: in the graph
            f = arm.lane_rhs(self.U, self.W)
            s = self.state
            for _ in range(RK45_CHUNK):
                s = I.rk45_iteration(f, s, self.T)
            return s

        def write(s):
            for buf, v in zip(self.state, s):
                buf.copy_(v)
        self.graph, _ = _capture(lambda: write(chunk()), chunk, device)
        self.replays = 0

    def __call__(self, X, U, W) -> torch.Tensor:
        t, x, h, i = self.state
        self.U.copy_(U)
        self.W.copy_(W)
        t.zero_()
        x.copy_(X)
        h.fill_(self.T / 50.0)
        i.zero_()
        while bool(I.rk45_active(self.state, self.T, 1000).any()):
            self.graph.replay()
            self.replays += 1
        return x.clone()
