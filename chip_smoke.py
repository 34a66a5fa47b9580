"""GPU smoke run of the PyTorch/CUDA port (``koopman_realizations_torch``).

Run from the root of a checkout on a machine with an NVIDIA GPU (H100) and
the CUDA toolkit:

    python chip_smoke.py

It builds the two CUDA kernels of the closed loop from ``csrc/`` (one nvcc
per source, in parallel), holds each against its plain PyTorch version on
the card, checks the fused loop's tracking quality against the JAX
reference value recorded in the model asset, drives the fused closed loop
at the bench's size (B=262144 lanes, 301 blockM steps) and the general
runner at B=65536, and prints: the card's name and power limit, one JSON
line with every kernel's launches, error, times and bound, and as the last
line {"ok": true, "device": {...}}.  Any failed phase raises; without CUDA
or outside a checkout it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# bench configuration (bench.py:95-122 of the JAX package)
MPC = dict(horizon=10, qp_iters=4, qp_dual_warm=True,
           input_blocks=(1, 1, 2, 5),
           input_bounds=(-7 * 3.141592653589793 / 8,
                         7 * 3.141592653589793 / 8),
           input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
           cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5))
ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
           substeps=3, newton_iters=1, jac_mode="step")
B_MAIN, B_GENERAL, B_CHECK, STEPS = 262144, 65536, 8192, 301
# H100 SXM published peaks: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of fn() on the card in ms (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def nnz(t) -> int:
    return int((t != 0).sum())


def qp_ops(qp, iters: int) -> int:
    """Operations one lane's QP needs, counted from csrc/kmpc_device.cuh
    (FMA = 2; divide, sqrt, compare and min/max = 1), leaving out the
    structural zeros of this run's lane-shared operands: no product with
    a zero entry of the generators, A, Wd, Wo or F0r, and no Gram term of
    an all-zero W generator row (a stage no move reaches)."""
    n, mc, p, m = qp.n, qp.mc, qp.p, qp.m
    nf = qp.nz + qp.nmono
    feat = (qp.gens[:, :nf] != 0).sum(1).tolist()
    const = (qp.gens[:, nf] != 0).tolist()
    gen = [2 * f + c for f, c in zip(feat, const)]     # one row against f
    live = [g > 0 for g in gen]
    pn, mp, nA = p * n, m * p, nnz(qp.A)
    ops = qp.nmono                                      # monomials
    ops += sum(gen[pn + mp:]) + p                       # v = Pgen f - sqYr
    ops += sum(gen[pn:pn + mp]) + 2 * sum(live[pn:pn + mp])   # + CB0 u
    for r in range(p):                                  # W rows -> Gram, qv
        k = sum(live[r * n:(r + 1) * n])
        ops += sum(gen[r * n:(r + 1) * n]) + 2 * k + k * (k + 1)
    ops += n + n * (n + 1) // 2 + 2 * nnz(qp.F0r)       # x2, b
    ops += 2 * n + 1 + n * (n + 1) // 2 + n + 4 * mc    # obj, Pr, q, lam0
    chol = 2 * n + n * (n + 1) // 2 + (n - 1) * n * (n + 1) // 3
    direction = 4 * nA + 7 * mc + n + 2 * n * n         # A^T t, solve, A dx
    per_iter = (2 * mc + 1                              # mu
                + 2 * nA + 3 * mc                       # r_p, max |r_p|
                + 2 * nA + 2 * n * n + 2 * n + 2        # r_d, active
                + 3 * mc                                # D
                + 2 * nnz(qp.Wd) + n + 2 * nnz(qp.Wo) + n - qp.band
                + chol + mc                             # factor, r_slam
                + 2 * direction + 4 * 3 * mc + 2        # dirs, step ratios
                + 6 * mc + 4 + 4 * mc + 1               # mu_aff, corrector
                + 3 * n + 6 * mc)                       # update
    return ops + 2 * nA + 2 * mc + iters * per_iter    # + slack start


def ok_ops(qp) -> int:
    """Operations of the ok mask (gap, primal residual, finite x)."""
    return 2 * qp.mc + 1 + 2 * nnz(qp.A) + 3 * qp.mc + qp.n


def rhs_ops(nl: int, k: int) -> int:
    """Operations of arm_rhs in csrc/kmpc_device.cuh on floats (k = 0) or
    on dual numbers with k tangents, each operation costed on its type as
    the source does it (zero tangents of constants included)."""
    dual = k > 0
    add, smul = 1 + k, 1 + k                            # T + T, float * T
    mul = 1 + 3 * k                                     # T * T
    div = 3 + 4 * k if dual else 1                      # T / T
    trig = sqrt = 2 + k if dual else 1                  # sin, cos, sqrt
    pairs = nl * (nl - 1) // 2
    ops = 2 * (nl - 1) * add                            # joint angle sums
    ops += pairs * (add + 2 * trig)                     # sin, cos of diffs
    ops += 1 + 2 * nl + pairs * (1 + smul)              # mass matrix
    ops += 2 * nl * (nl - 1) * add + nl * mul           # suffix sums, rates^2
    ops += nl * ((nl - 1) * (1 + smul + mul) + (nl - 2) * add)  # Coriolis
    ops += (nl - 1) * add                               # its suffix sum
    ops += nl * (2 + trig + 3 * smul + add) + (nl - 1) * add  # gravity
    ops += nl * (1 + 2 * smul + 3 * add)                # damping, torques
    ops += sum(j * (mul + add) + sqrt + (nl - 1 - j) * (j * (mul + add) + div)
               for j in range(nl))                      # Cholesky
    return ops + nl * (nl - 1) * (mul + add) + 2 * nl * div    # solve


def plant_ops(cfg) -> int:
    """Operations of one lane's SDIRK2 period and markers, counted from
    csrc/kmpc_device.cuh (jac_mode 'step': one dual-number Jacobian)."""
    nl, nx = cfg.Nlinks, cfg.nx
    chol = sum(2 * j + 1 + (nx - 1 - j) * (2 * j + 1) for j in range(nx))
    solve = 2 * nx * (nx - 1) + 2 * nx
    factor = (rhs_ops(nl, nx) + 2 * nx * nx
              + nx * (nx + 1) // 2 * (2 * nx - 1) + chol)
    newton = 2 * nx + rhs_ops(nl, 0) + nx + nx * (2 * nx - 1) + solve + nx
    substep = rhs_ops(nl, 0) + 2 * cfg.newton_iters * newton + 7 * nx
    markers = 7 * nl - 3
    return 6 + factor + cfg.substeps * substep + markers


def step_tail_ops(qp, op, cfg) -> int:
    """The step kernel's epilogue: input unscaling, finite check, output
    scaling, Pwarm @ x by its nonzeros, the dual carry."""
    return 2 * qp.m + cfg.nx + 2 * cfg.ny + 2 * nnz(op.Pwarm) + qp.mc


def bound(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def shared_bytes(qp, extra=()) -> int:
    return 4 * sum(t.numel() for t in (qp.gens, qp.rdiag, qp.A, qp.cFr,
                                       qp.F0r, qp.Wd, qp.Wo, *extra))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "koopman_realizations_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from koopman_realizations_torch.config import ArmConfig, MpcConfig
    from koopman_realizations_torch.control.kmpc import BilinearKmpc
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.ops.kernels import _build
    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    from koopman_realizations_torch.ops.kernels import step_fused as SF
    from koopman_realizations_torch.ops.qp import ok_mask
    from koopman_realizations_torch.utils.checkpoint import load_model
    from koopman_realizations_torch.utils.metrics import lane_tracking_error
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- model, controller, plant; build both kernels at once
    model, scaler, header = load_model()
    jref = header["jax_reference"]
    dev = torch.device("cuda")
    mpc = BilinearKmpc(model, scaler, MpcConfig(**MPC), device=dev)
    arm = Arm(ArmConfig(**ARM), device=dev)
    sim = Ksim(arm, mpc)
    op = SF.build_step_fused(mpc, arm, scaler)
    qp = op.qp
    ref = blockM_reference()
    wins = sim.reference_windows(ref, STEPS)
    builds = _build.build_all([BL.kernel_spec(qp), op.kernel_spec()])
    for r in builds:
        log(f"built {r.path.name} in {r.seconds:.1f} s "
            f"({'cached' if r.cached else 'nvcc'})")
        for ln in r.ptxas:
            log("  " + ln.strip())

    def carry_after(B, steps, step_op=op, w=wins):
        """Carry after ``steps`` plain closed-loop steps from the bench's
        initial states spread over B lanes."""
        X0 = np.zeros((B, 6), np.float32)
        X0[:, 0] = np.linspace(-0.2, 0.2, B)
        c = step_op.init_carry(X0, np.zeros((B, 2), np.float32))
        for k in range(steps):
            c = step_op.step_plain(c, w[k])
        return c

    # ---- phase 1: bilin_lift kernel against its plain version, B=8192
    def lane_windows(B, k0):
        """Per-lane reference windows (p, B): lane b takes the window of
        step k0 + b % 8, so neighbouring lanes track different targets."""
        k = k0 + torch.arange(B, device=dev) % 8
        return wins[k].T.contiguous()

    def check_bilin(c, warm, sq, label) -> float:
        """bilin_lift kernel against its plain version on one carry's
        lanes; returns max |dx|."""
        args = (qp, c.ysc, c.upsc, c.x0 if warm else torch.zeros_like(c.x0),
                c.lamc if warm else None, sq, mpc.cfg.qp_iters,
                1e-2 if warm else 1.0)
        xk, sk, lk, objk = BL.bilin_lift_cuda(*args)
        torch.cuda.synchronize()
        xp, sp, lp, objp = BL.bilin_lift_plain(*args)
        b = qp.cFr[:, None] - qp.F0r @ c.upsc
        okk = ok_mask(qp, b, xk, sk, lk, 3e-3, 5e-2)[0]
        okp = ok_mask(qp, b, xp, sp, lp, 3e-3, 5e-2)[0]
        dx = (xk - xp).abs().max().item()
        dl = (lk - lp).abs().max().item() / lp.abs().max().item()
        dobj = ((objk - objp) / objp).abs().max().item()
        log(f"bilin_lift {label}: max|dx| {dx:.3e} max|dlam|/max|lam| "
            f"{dl:.3e} max rel dobj {dobj:.3e} ok "
            f"{int(okk.sum())}/{int(okp.sum())} of {c.ysc.shape[1]}")
        # two f32 evaluations in different operation orders; each is
        # ~1e-5 from the f64 solution in the CPU tests
        if not (dx < 1e-3 and dl < 1e-3 and dobj < 1e-5
                and torch.equal(okk, okp) and bool(okk.all())):
            raise AssertionError("bilin_lift kernel disagrees with plain")
        return dx

    def check_step(c, sq, label) -> float:
        """step_fused kernel against its plain version on one carry;
        returns the max |d| over the outputs."""
        out = SF.StepCarry(*(torch.empty_like(t) for t in c))
        ck = op.step(c, sq, out=out)
        torch.cuda.synchronize()
        cp = op.step_plain(c, sq)
        d = {f: (getattr(ck, f) - getattr(cp, f)).abs().max().item()
             for f in SF.StepCarry._fields}
        log(f"step_fused {label}: " + " ".join(
            f"max|d{f}| {v:.3e}" for f, v in d.items()))
        # QP outputs: f32 orderings (<1e-3 of scale); plant outputs: the
        # f32 chord-Newton SDIRK2 is noisy at ~3e-3 in any two orderings
        if not (torch.equal(ck.alive, cp.alive) and d["upsc"] < 1e-3
                and d["x0"] < 1e-3
                and d["lamc"] < 1e-3 * cp.lamc.abs().max().item()
                and d["xpl"] < 2e-2):
            raise AssertionError("step_fused kernel disagrees with plain")
        return max(d.values())

    c = carry_after(B_CHECK, 3)
    bl_err = max(check_bilin(c, True, wins[3], f"warm B={B_CHECK}"),
                 check_bilin(c, False, wins[3], f"cold B={B_CHECK}"),
                 check_bilin(c, True, lane_windows(B_CHECK, 3),
                             f"warm, per-lane windows B={B_CHECK}"))

    # ---- phase 2: step_fused kernel against its plain version, B=8192
    c = carry_after(B_CHECK, 5)
    sf_err = max(check_step(c, wins[5], f"one step B={B_CHECK}"),
                 check_step(c, lane_windows(B_CHECK, 5),
                            f"one step, per-lane windows B={B_CHECK}"))

    # 20-step runners: kernel vs plain f32 vs plain f64 reference
    K = 20
    ck = carry_after(B_CHECK, 0)
    cp = carry_after(B_CHECK, 0)
    mpc64 = BilinearKmpc(model, scaler, MpcConfig(**MPC), device=dev,
                         dtype=torch.float64)
    op64 = SF.build_step_fused(mpc64, arm, scaler)
    wins64 = Ksim(arm, mpc64).reference_windows(ref, STEPS)
    c64 = carry_after(B_CHECK, 0, step_op=op64, w=wins64)
    dY = []
    for k in range(K):
        ck = op.step(ck, wins[k])
        cp = op.step_plain(cp, wins[k])
        c64 = op64.step_plain(c64, wins64[k])
        if not torch.equal(ck.alive, cp.alive):
            raise AssertionError(f"alive masks differ at step {k}")
        dY.append((ck.yp - cp.yp).abs().max().item())
    ek = (ck.yp.double() - c64.yp).abs().max(0).values
    ep = (cp.yp.double() - c64.yp).abs().max(0).values
    med = (ck.yp - cp.yp).abs().max(0).values.median().item()
    log(f"step_fused 20-step runners: max|dYp| first 5 {max(dY[:5]):.3e}, "
        f"all 20 {max(dY):.3e}, median lane at 20 {med:.3e}; error vs f64: "
        f"kernel max {ek.max():.3e} median {ek.median():.3e}, plain max "
        f"{ep.max():.3e} median {ep.median():.3e}; alive "
        f"{ck.alive.mean().item():.4f}")
    # single lanes of the early blockM transient amplify f32 plant noise
    # (CPU emulation of this kernel: 6.4e-3 / 7.1e-2 / 4e-4 at B=8192);
    # the kernel must be as accurate as the plain f32 runner against f64
    if not (max(dY[:5]) < 2e-2 and max(dY) < 0.2 and med < 2e-3
            and ek.median() <= 2 * ep.median() + 1e-4
            and ek.max() <= 2 * ep.max() + 1e-2
            and bool(ck.alive.all())):
        raise AssertionError("step_fused runner disagrees with plain")
    del c64, op64, mpc64, wins64

    # ---- phase 3: quality through the kernel, bench X0, B=16, 301 steps
    X16 = np.zeros((16, 6), np.float32)
    X16[:, 0] = np.linspace(-0.2, 0.2, 16)
    o16 = sim.fused_runner(ref, steps=STEPS)(X16, np.zeros((16, 2),
                                                             np.float32))
    e16 = lane_tracking_error(o16["Yp"], ref)
    log(f"quality B=16: alive {o16['alive'][:, -1].float().mean():.4f} "
        f"err_mean {e16.mean():.6f} err_worst {e16.max():.6f} (JAX general "
        f"runner {jref['err_mean']:.6f} / {jref['err_worst']:.6f})")
    # f32 plant noise moves the mean by ~1e-4 on the CPU (tests); 1e-3 = 3%
    if not (bool(o16["alive"].all()) and torch.isfinite(o16["Yp"]).all()
            and abs(e16.mean().item() - jref["err_mean"]) < 1e-3):
        raise AssertionError("fused loop quality off the JAX reference")

    # ---- phase 4: main path at size -- fused runner, B=262144, 301 steps
    XB = np.zeros((B_MAIN, 6), np.float32)
    XB[:, 0] = np.linspace(-0.2, 0.2, B_MAIN)
    WB = np.zeros((B_MAIN, 2), np.float32)
    run = sim.fused_runner(ref, steps=STEPS)
    run(XB[:1024], WB[:1024])                       # warm-up (allocator)
    SF.step_fused_cuda.launches = 0
    BL.bilin_lift_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    main_out = run(XB, WB)
    t1.record()
    torch.cuda.synchronize()
    wall = t0.elapsed_time(t1) / 1e3
    launches_sf = SF.step_fused_cuda.launches
    if BL.bilin_lift_cuda.launches or launches_sf != STEPS - 1:
        raise AssertionError(f"fused path launches: step_fused "
                             f"{launches_sf}, bilin_lift "
                             f"{BL.bilin_lift_cuda.launches}")
    eB = lane_tracking_error(main_out["Yp"], ref)
    aliveB = main_out["alive"][:, -1].float().mean().item()
    rate = B_MAIN * (STEPS - 1) / wall
    log(f"fused main path B={B_MAIN} steps={STEPS}: {wall:.3f} s (incl. "
        f"carry init and reference setup), {rate:.4e} lane-steps/s, alive "
        f"{aliveB:.6f}, err_mean {eB.mean():.6f}, err_worst {eB.max():.6f}"
        f" | {smi}")
    if aliveB != 1.0 or not torch.isfinite(eB).all():
        raise AssertionError("fused main path lost lanes")
    del main_out

    # ---- phase 5: the general runner (bilin_lift path) at B=65536
    grun = sim.batched_runner(ref, steps=STEPS)
    sim.batched_runner(ref, steps=3)(XB[:1024], WB[:1024])   # warm-up
    XG = np.zeros((B_GENERAL, 6), np.float32)
    XG[:, 0] = np.linspace(-0.2, 0.2, B_GENERAL)
    WG = np.zeros((B_GENERAL, 2), np.float32)
    SF.step_fused_cuda.launches = 0
    BL.bilin_lift_cuda.launches = 0
    torch.cuda.synchronize()
    t0.record()
    gout = grun(XG, WG)
    t1.record()
    torch.cuda.synchronize()
    gwall = t0.elapsed_time(t1) / 1e3
    launches_bl = BL.bilin_lift_cuda.launches
    if SF.step_fused_cuda.launches or launches_bl != STEPS - 1:
        raise AssertionError(f"general path launches: bilin_lift "
                             f"{launches_bl}")
    eG = lane_tracking_error(gout["Yp"], ref)
    aliveG = gout["alive"][:, -1].float().mean().item()
    log(f"general runner B={B_GENERAL} steps={STEPS}: {gwall:.3f} s, "
        f"{B_GENERAL * (STEPS - 1) / gwall:.4e} lane-steps/s, alive "
        f"{aliveG:.6f}, err_mean {eG.mean():.6f}, err_worst "
        f"{eG.max():.6f} | {smi}")
    if aliveG != 1.0:
        raise AssertionError("general runner lost lanes")
    del gout

    # ---- phase 6: each kernel against its plain version, and its time, at
    # the main path's shapes
    cB = op.init_carry(XB, WB)
    sf_err = max(sf_err, check_step(cB, wins[0], f"one step B={B_MAIN}"))
    oB = SF.StepCarry(*(torch.empty_like(t) for t in cB))
    sf_ms = cuda_ms(lambda: op.step(cB, wins[0], out=oB), reps=10)
    sf_plain = cuda_ms(lambda: op.step_plain(cB, wins[0]), reps=2, warmup=1)
    sf_flops = (qp_ops(qp, op.iters) + ok_ops(qp) + plant_ops(arm.cfg)
                + step_tail_ops(qp, op, arm.cfg)) * B_MAIN
    sf_bytes = 4 * B_MAIN * (2 * sum(t.shape[0] if t.ndim == 2 else 1
                                     for t in cB) - 2) \
        + 4 * qp.p + shared_bytes(qp, (op.Pwarm,))
    sf_bound, sf_by = bound(sf_flops, sf_bytes)
    # breakdown: the QP half alone on the same lanes (the step kernel's
    # remainder is the plant, the freeze and the carry advance)
    qp_ms = cuda_ms(lambda: BL.bilin_lift_cuda(
        qp, cB.ysc, cB.upsc, cB.x0, cB.lamc, wins[0], op.iters, 1e-2),
        reps=10)
    log(f"breakdown at B={B_MAIN}: QP alone (bilin_lift) {qp_ms:.4f} ms "
        f"of the step's {sf_ms:.4f} ms")
    del cB, oB
    cG = op.init_carry(XG, WG)
    bl_err = max(bl_err, check_bilin(cG, True, wins[0],
                                     f"warm B={B_GENERAL}"))
    ins = (qp, cG.ysc, cG.upsc, cG.x0, cG.lamc, wins[0], op.iters, 1e-2)
    bl_ms = cuda_ms(lambda: BL.bilin_lift_cuda(*ins), reps=10)
    bl_plain = cuda_ms(lambda: BL.bilin_lift_plain(*ins), reps=2, warmup=1)
    bl_flops = qp_ops(qp, op.iters) * B_GENERAL
    bl_bytes = 4 * B_GENERAL * (qp.nz + qp.m + qp.n + qp.mc
                                + qp.n + 2 * qp.mc + 1) \
        + 4 * qp.p + shared_bytes(qp)
    bl_bound, bl_by = bound(bl_flops, bl_bytes)
    log(f"kernel times | {smi}: step_fused {sf_ms:.4f} ms (plain "
        f"{sf_plain:.2f} ms, bound {sf_bound:.4f} ms by {sf_by}, "
        f"{sf_flops / B_MAIN:.0f} op/lane) at B={B_MAIN}; bilin_lift "
        f"{bl_ms:.4f} ms (plain {bl_plain:.2f} ms, bound {bl_bound:.4f} ms "
        f"by {bl_by}, {bl_flops / B_GENERAL:.0f} op/lane) at B={B_GENERAL}")

    tpu = "koopman_realizations_tpu/ops/pallas/"
    kernels = [
        {"name": "step_fused", "route": "cuda",
         "source": "koopman_realizations_torch/csrc/step_fused.cu",
         "replaces": tpu + "step_fused.py:90", "launches": launches_sf,
         "max_abs_err": sf_err, "ms": sf_ms, "plain_ms": sf_plain,
         "bound_ms": sf_bound, "bound_by": sf_by, "library_ms": None},
        {"name": "bilin_lift", "route": "cuda",
         "source": "koopman_realizations_torch/csrc/bilin_lift.cu",
         "replaces": tpu + "qp_ipm.py:772", "launches": launches_bl,
         "max_abs_err": bl_err, "ms": bl_ms, "plain_ms": bl_plain,
         "bound_ms": bl_bound, "bound_by": bl_by, "library_ms": None},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
