"""Closed-loop evaluation of a lasso sweep, every candidate model in one
batch (port of ``workflows/lasso_sweep.py:29-108`` of the JAX package;
BASELINE config #3, a lasso sweep that trains several models in one
batch).

The reference trains one candidate per lasso value
(``Ksysid.train_models:1344-1389``) and would run them one
``Ksim.run_trial_mpc`` at a time.  Here each candidate is a lane of one
closed loop: per step the bilinear MPC's first pass about Beta(z) held
over the horizon (and with ``bilinear_iters`` > 1 each later pass about
the lifted trajectory re-rolled under the previous pass's plan,
``sweep_qp_relinearized``, its duals the previous pass's) (JAX ``bilinear_solve_pure``, ``control/kmpc.py:
713-742``, through the routed solver's per-lane-generators branch,
``ops/qp.py:381-389``) in three steps on the device -- the factored QP's
W, v and b assembled per lane against the lane's own generators
(``_bilin_assemble``), the dense P = 2 (W'W + diag r), q = 2 W'v
(``_factored_Pq``), and the interior point with a per-lane P and the
lane-shared constraint rows (``ops/qp.py:solve_qp``: the ``KM_LANE_P``
build of the ``ipm_shared`` kernel on the card, its plain version on the
CPU) -- then one period of the arm plant.  The constraint stack, cost
diagonals and blocking are functions of the configuration and the scaler
alone, so they stay shared (JAX ``lasso_sweep.py:44-50``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control.kmpc import (
    BilinearKmpc,
    bilinear_generators,
)
from koopman_realizations_torch.models.koopman import BilinearModel
from koopman_realizations_torch.ops.qp import factored_gram, solve_qp


def sweep_generators(mpc: BilinearKmpc, cands, dtype, device) -> dict:
    """Every candidate's assembly generators stacked on a leading lane
    axis: PGW (C, p*n, NL) (Tb-folded when blocked), PG0 (C, m*p, NL),
    PAsq (C, p, NL), f64 on the host, and the lane-shared reduced
    constraint stack cF (mc,), F0 (mc, m); with ``bilinear_iters`` > 1
    also what the later passes re-roll and re-assemble with (JAX
    ``bilinear_consts``, kmpc.py:526-547): A (C, NL, NL), Bm (C, NL, m,
    NL), PA (C, p, NL) and the block-Toeplitz PAt (C, Np+1, Np, nproj,
    NL); in ``dtype`` on ``device``."""
    # a candidate that fills several lanes (the same model object) is
    # assembled once and gathered on the device
    first, idx = {}, []
    for cd in cands:
        idx.append(first.setdefault(id(cd), len(first)))
    uniq = list({id(cd): cd for cd in cands}.values())
    gens = [bilinear_generators(cd, mpc.q_diag, mpc.proj_idx, mpc.Np,
                                mpc.m, mpc.Tb) for cd in uniq]
    out = {k: np.stack([g[src] for g in gens])
           for k, src in (("PGW", "PGWb"), ("PG0", "PG0"),
                          ("PAsq", "PAsq"))}
    if mpc.cfg.bilinear_iters > 1:
        out.update(
            A=np.stack([np.asarray(cd.A, np.float64) for cd in uniq]),
            Bm=np.stack([np.asarray(cd.B, np.float64) for cd in uniq]),
            PA=np.stack([g["PA"].reshape(mpc.p, -1) for g in gens]),
            PAt=np.stack([g["PAt"] for g in gens]))
    lane = torch.as_tensor(idx, device=device)
    out = {k: torch.as_tensor(v, dtype=dtype, device=device)[lane]
           for k, v in out.items()}
    out.update({k: torch.as_tensor(v, dtype=dtype, device=device)
                for k, v in (("cF", mpc.cF_red), ("F0", mpc.F0_red))})
    return out


def assemble_lanes(gens: dict, z, up, sqYr, m: int):
    """The factored QP of every lane against its own generators
    (``_bilin_assemble``, JAX ``ops/qp.py:272-282``), lanes-minor: z
    (NL, C), up (m, C) scaled u_prev, sqYr (p,).  Returns (Wf (p*n, C),
    v (p, C), b (mc, C))."""
    Wf = torch.einsum("crN,Nc->rc", gens["PGW"], z)
    CB0 = torch.einsum("crN,Nc->rc", gens["PG0"], z)
    v = torch.einsum("crN,Nc->rc", gens["PAsq"], z) - sqYr[:, None]
    p = v.shape[0]
    for j in range(m):
        v = v + CB0[j * p:(j + 1) * p] * up[j]
    b = gens["cF"][:, None] - gens["F0"] @ up
    return Wf, v, b


def sweep_qp(mpc: BilinearKmpc, gens: dict, z, up, sqYr, U_plan):
    """One step's QPs of every lane as ``solve_qp``'s positional
    operands: (P (n, n, C), q (n, C), the lane-shared ``Constraints``,
    b (mc, C), iters, x0 (n, C))."""
    Wf, v, b = assemble_lanes(gens, z, up, sqYr, mpc.m)
    cons = mpc.constraints()
    P, q = factored_gram(Wf, v, mpc.rdiag, v.shape[0], cons.n)
    return (P.contiguous(), q.contiguous(), cons, b.contiguous(),
            mpc.cfg.qp_iters, mpc.warm_start(U_plan).contiguous())


def sweep_qp_relinearized(mpc: BilinearKmpc, gens: dict, z, up, sqYr,
                          U_plan, U):
    """A later pass's QPs of every lane (``bilinear_solve_pure``'s
    iters > 1, kmpc.py:650-655, 726-742, 755-760): each lane's lifted
    state re-rolled under the previous pass's plan U (Np*m, C) through
    its own A and Beta, the block-Toeplitz CB of the stage Betas, then
    the factored QP W = sqrt(Q) CB[:, m:] (Tb when blocked), v =
    sqrt(Q) (CA z + CB[:, :m] u_prev) - sqrt(Q) Yr, as ``sweep_qp``'s
    operands."""
    m, Np, NL, C = mpc.m, mpc.Np, z.shape[0], z.shape[1]
    zk, betas = z, []
    for k in range(Np):
        betas.append(torch.einsum("ckmq,qc->kmc", gens["Bm"], zk))
        if k + 1 < Np:
            zk = torch.einsum("ckq,qc->kc", gens["A"], zk) \
                + torch.einsum("kmc,mc->kc", betas[-1], U[k * m:(k + 1) * m])
    CB = torch.einsum("cijrb,jbmc->irjmc", gens["PAt"],
                      torch.stack(betas)).reshape(mpc.p, Np * m, C)
    sq = torch.as_tensor(mpc.sqq, dtype=z.dtype, device=z.device)[:, None]
    W = sq[..., None] * CB[:, m:]
    if mpc.blocked:
        W = torch.einsum("rjc,jk->rkc", W, mpc.Tb_t)
    v = sq * (torch.einsum("crN,Nc->rc", gens["PA"], z)
              + torch.einsum("rjc,jc->rc", CB[:, :m], up)) - sqYr[:, None]
    cons = mpc.constraints()
    P, q = factored_gram(W.reshape(-1, C), v, mpc.rdiag, v.shape[0], cons.n)
    b = gens["cF"][:, None] - gens["F0"] @ up
    return (P.contiguous(), q.contiguous(), cons, b.contiguous(),
            mpc.cfg.qp_iters, mpc.warm_start(U_plan).contiguous())


def lasso_sweep_closed_loop(ksysid, plant, mpc_cfg: MpcConfig, ref,
                            steps: Optional[int] = None, device="cuda",
                            dtype=torch.float32,
                            qp_hook: Optional[Callable] = None) -> dict:
    """Run the closed loop for every candidate model at once, a lane
    each, from the plant at rest.

    ksysid: a trained ``Ksysid`` whose ``candidates`` are bilinear models
    of one shape (one per lasso value); ``plant`` the arm on ``device``;
    ``ref`` (T, nproj) the reference; ``steps`` closed-loop samples
    (default T), steps - 1 steps.  The loop keeps the JAX sweep's rules:
    step k (1-based) tracks the scaled reference from row k-1 (padded with
    Np+1 repeats of row steps-1), the applied input is the plan's second
    row, the plant takes the previous input, duals start cold, and a
    candidate freezes for good on a failed solve or a non-finite plant
    state.  ``qp_hook``, if given, is called each step with the step's
    ``solve_qp`` operands (``sweep_qp``), its solution and the
    lanes alive after the step.  Returns {"err": (C, steps-1) Euclidean
    error on ``proj_idx``, "alive": (C, steps-1) bool, "lasso": [C]} as
    numpy."""
    cands = ksysid.candidates
    if not cands or not all(isinstance(cd, BilinearModel) for cd in cands):
        raise NotImplementedError("lasso_sweep_closed_loop takes bilinear "
                                  "candidates only")
    dev = resolve_device(device)
    if plant.G.device.type != dev.type:
        raise ValueError(f"the plant ({plant.G.device}) must live on "
                         f"{dev}")
    scaler = ksysid.scaler
    mpc = BilinearKmpc(cands[0], scaler, mpc_cfg, device=dev, dtype=dtype)
    gens = sweep_generators(mpc, cands, dtype, dev)
    Np, m, C = mpc.Np, mpc.m, len(cands)
    proj = list(mpc.proj_idx)
    ref = np.asarray(ref, float)
    K = ref.shape[0] if steps is None else int(steps)
    ref_sc = np.asarray(scaler.ref_down(ref[:K], mpc.proj_idx), float)
    ref_pad = np.concatenate([ref_sc, np.tile(ref_sc[-1:], (Np + 1, 1))])
    # window of step k (1-based) starts at row k-1
    wins = np.stack([ref_pad[k - 1:k + Np].reshape(-1)
                     for k in range(1, K)])
    sqYr = torch.as_tensor(mpc.sqq * wins, dtype=dtype, device=dev)
    ref_err = torch.as_tensor(
        np.asarray(scaler.ref_up(ref_pad[:K - 1], mpc.proj_idx), float),
        dtype=dtype, device=dev)

    x = torch.zeros((plant.cfg.nx, C), dtype=dtype, device=dev)
    W0 = torch.zeros((2, C), dtype=dtype, device=dev)
    ysc = scaler.y_down(plant.get_y(x), axis=0)
    u_prev = torch.zeros((m, C), dtype=dtype, device=dev)
    U_plan = torch.zeros((Np * m, C), dtype=dtype, device=dev)
    alive = torch.ones(C, dtype=torch.bool, device=dev)
    err = torch.empty((K - 1, C), dtype=dtype, device=dev)
    alive_rec = torch.empty((K - 1, C), dtype=torch.bool, device=dev)
    for k in range(K - 1):
        up = scaler.u_down(u_prev, axis=0)
        z = mpc.lift(ysc)
        qp = sweep_qp(mpc, gens, z, up, sqYr[k], U_plan)
        sol = solve_qp(*qp)
        U = mpc.plan(up, sol.x)
        for _ in range(mpc_cfg.bilinear_iters - 1):
            # the next pass about the trajectory under this pass's plan,
            # its duals the previous pass's
            qp = sweep_qp_relinearized(mpc, gens, z, up, sqYr[k], U_plan,
                                       U)
            sol = solve_qp(*qp, lam0=sol.lam)
            U = mpc.plan(up, sol.x)
        u_next = scaler.u_up(U[m:2 * m], axis=0)
        x_new = plant.step(x, u_prev, W0)
        alive = alive & sol.ok & torch.isfinite(x_new).all(0)
        keep = lambda new, old: torch.where(alive, new, old)
        x = keep(x_new, x)
        y = plant.get_y(x)
        ysc = scaler.y_down(y, axis=0)
        u_prev = keep(u_next, u_prev)
        U_plan = keep(U, U_plan)
        err[k] = torch.sqrt(((ref_err[k][:, None] - y[proj]) ** 2).sum(0))
        alive_rec[k] = alive
        if qp_hook is not None:
            qp_hook(qp, sol, alive)
    return {"err": err.T.cpu().numpy(), "alive": alive_rec.T.cpu().numpy(),
            "lasso": [float(cd.lasso) for cd in cands]}
