"""The cooperative interior point's launch plan (``ops/kernels/
ipm_group.py``) for every build that uses it: ``ipm_factored``'s four
(iterated relinearization n=12/mc=48, its q0 build on the NMPC's 'linear'
update, the unblocked stack n=27/mc=108, with smoothness rows
n=27/mc=156 dense), ``nmpc_multipass``'s, the one-pass NMPC kernels'
(``nmpc_stage``'s three trajectory modes, ``nmpc_pass``), the fused
steps' (``step_fused``, ``linear_step_fused``), ``bilin_lift``'s,
``bilin``'s and ``ipm_shared``'s (lane-shared; per-lane P at n=12 and
n=27).  Pure
Python:
the group size,
lanes per block, the grid over B with a ragged tail, the shared-memory
layout within the H100's 227 KB a block, and the dense A^T D A entry table
against the plain dense form.  The kernels themselves run only on the
card (tests/test_torch_cuda.py)."""

import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import (
    BilinearKmpc,
    LinearKmpc,
    NonlinearKmpc,
)
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels import bilin as BI
from koopman_realizations_torch.ops.kernels import bilin_lift as BL
from koopman_realizations_torch.ops.kernels import ipm_factored as IF
from koopman_realizations_torch.ops.kernels import ipm_group as IG
from koopman_realizations_torch.ops.kernels import ipm_shared as IS
from koopman_realizations_torch.ops.kernels import linear_step_fused as LS
from koopman_realizations_torch.ops.kernels import nmpc_multipass as NM
from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
from koopman_realizations_torch.ops.kernels import nmpc_stage as NS
from koopman_realizations_torch.ops.kernels import step_fused as SF
from koopman_realizations_torch.ops.kernels._build import CSRC
from koopman_realizations_torch.ops.nmpc import STAGE_MODES
from koopman_realizations_torch.ops.qp import form_AtDA
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    NONLINEAR_MODEL,
    load_model,
)

from test_torch_oracle import (
    BENCH_ARM,
    BENCH_MPC,
    BILINEAR_ROUTES,
    LINEAR_MPC,
    NMPC_MPC,
)
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

# (n, mc, band, group) of each build
EXPECTED = {"iters2": (12, 48, 3, IG.NARROW_GROUP),
            "unblocked": (27, 108, 3, 32),
            "unblocked_smooth": (27, 156, None, 32),
            "q0": (12, 48, 3, IG.NARROW_GROUP),
            "nmpc_multipass": (12, 48, 3, IG.NMPC_GROUP),
            **{"nmpc_stage " + mode: (12, 48, 3, IG.ONEPASS_GROUP)
               for mode in STAGE_MODES},
            "nmpc_pass": (12, 48, 3, IG.ONEPASS_GROUP),
            "step_fused": (12, 48, 3, IG.STEP_GROUP),
            "linear_step_fused": (12, 48, 3, IG.STEP_GROUP),
            "bilin_lift": (12, 48, 3, IG.STEP_GROUP),
            "bilin": (12, 48, 3, IG.STEP_GROUP),
            "ipm_shared": (12, 48, 3, IG.SHARED_GROUP),
            "ipm_shared lane-P n=12": (12, 48, 3, IG.LANE_P_NARROW_GROUP),
            "ipm_shared lane-P n=27": (27, 108, 3, 32)}
# the one-pass NMPC builds, the fused steps, and with nmpc_multipass the
# compact plans (a lane a thread in the stage sweep or the step's front,
# the hand-over through device scratch)
ONEPASS = ["nmpc_stage " + mode for mode in STAGE_MODES] + ["nmpc_pass"]
STEPS = ["step_fused", "linear_step_fused"]
# bilin_lift and bilin (a front launch, then the group solve), and
# ipm_shared's builds: the solve launch alone, its QPs from the caller
# (the per-lane P one round a block)
LANE_P = ["ipm_shared lane-P n=12", "ipm_shared lane-P n=27"]
ONE_ROUND = ["ipm_shared"] + LANE_P
FRONTED = ["bilin_lift", "bilin"]
SOLVES = FRONTED + ONE_ROUND
COMPACT = ["nmpc_multipass"] + ONEPASS + STEPS + FRONTED


@pytest.fixture(scope="module")
def nmpc_qp():
    """The NMPC controller's QP operands (f32, on the CPU)."""
    nmodel, nscaler, _ = load_model(NONLINEAR_MODEL)
    nm = NonlinearKmpc(nmodel, nscaler, MpcConfig(**NMPC_MPC), device="cpu")
    return nm.nmpc_qp()


@pytest.fixture(scope="module")
def plans(nmpc_qp):
    """Each build's constraints and plan, as its wrapper makes it."""
    model, scaler, _ = load_model()
    out = {}
    for name, knobs in BILINEAR_ROUTES.items():
        m = BilinearKmpc(model, scaler, MpcConfig(**{**BENCH_MPC, **knobs}),
                         device="cpu")
        out[name] = (m.constraints(), IF.launch_plan(m.constraints(), m.p))
        if name == "iters2":
            out["bilin"] = (m.bilin_qp().cons, BI.launch_plan(m.bilin_qp()))
    q = nmpc_qp
    out["q0"] = (q.cons, IF.launch_plan(q.cons, q.p))
    out["nmpc_multipass"] = (q.cons, NM.launch_plan(q))
    for mode in STAGE_MODES:
        out["nmpc_stage " + mode] = (q.cons, NS.launch_plan(q))
    out["nmpc_pass"] = (q.cons, NP.launch_plan(q))
    for build, op in step_ops().items():
        out[build] = (op.cons, op.launch_plan())
    lift = step_ops()["step_fused"].qp
    out["bilin_lift"] = (lift.cons, BL.launch_plan(lift))
    lcons = step_ops()["linear_step_fused"].cons
    out["ipm_shared"] = (lcons, IS.launch_plan(lcons))
    # the per-lane P of the 'linear' update's QPs and the unblocked route's
    for key, c in (("n=12", q.cons), ("n=27", out["unblocked"][0])):
        out["ipm_shared lane-P " + key] = (c, IS.launch_plan(c, True))
    return out


_STEP_OPS = {}


def step_ops() -> dict:
    """The fused steps of the bench's bilinear controller and of the
    linear one (f32, on the CPU), made once."""
    if not _STEP_OPS:
        arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
        model, scaler, _ = load_model()
        lmodel, lscaler, _ = load_model(LINEAR_MODEL)
        _STEP_OPS["step_fused"] = SF.build_step_fused(
            BilinearKmpc(model, scaler, MpcConfig(**BENCH_MPC),
                         device="cpu"), arm, scaler)
        _STEP_OPS["linear_step_fused"] = LS.build_linear_step_fused(
            LinearKmpc(lmodel, lscaler, MpcConfig(**LINEAR_MPC),
                       device="cpu"), arm, lscaler)
    return _STEP_OPS


@pytest.mark.parametrize("build", list(EXPECTED))
def test_plan_of_each_build(plans, build):
    """Group size from (n, mc), lanes per block, rounds, grid over B with
    a ragged tail, and the shared memory within one block's 227 KB."""
    cons, plan = plans[build]
    n, mc, band, group = EXPECTED[build]
    assert (cons.n, cons.mc, cons.band) == (n, mc, band)
    assert plan.group == group
    if build not in COMPACT + ONE_ROUND:
        assert plan.group == IG.choose_group(n, mc)
    assert plan.threads % plan.group == 0
    if build in COMPACT:
        # a lane a thread in the sweep; threads // group lanes a round
        assert plan.lanes == plan.threads == IG.NMPC_THREADS
        assert plan.rounds == plan.group
    elif build in ONE_ROUND:
        # ipm_shared: one round of lanes a block; the per-lane P wide a
        # warp a lane with no bound on the blocks an SM
        assert plan.threads == IG.FACTORED_THREADS
        assert plan.lanes == plan.groups and plan.rounds == 1
        assert plan.compact and plan.lane_p == (build in LANE_P)
        assert plan.p == 0 and plan.min_blocks == (
            IG.SHARED_MIN_BLOCKS if build == "ipm_shared"
            else 0 if n >= IG.WIDE_N else IG.LANE_P_NARROW_MIN_BLOCKS)
    else:
        assert plan.threads == IG.FACTORED_THREADS
        assert plan.lanes == plan.threads // plan.group
        assert plan.rounds == 1 and plan.p == 22
    for B in (1, plan.lanes - 1, plan.lanes, plan.lanes + 1, 1007, 65536):
        grid = plan.grid(B)
        assert (grid - 1) * plan.lanes < B <= grid * plan.lanes
    assert 0 < plan.smem_bytes <= IG.SMEM_LIMIT == 232448


@pytest.mark.parametrize("build", list(EXPECTED))
def test_layout_regions(plans, build):
    """The regions follow each other without overlap and hold what the
    kernels put there: each lane region x, obj and max(T + n + m, 2 mc)
    floats (the Hessian, q and u_prev, or s and lam; nmpc_multipass's
    compact plan x, obj and u_prev, its stride odd); each work region M, dx
    and the row vector (compact: and the lane's Hessian); strides padded
    to 32k + group (32k + 1 for a warp) so that the groups of one warp
    read disjoint banks."""
    cons, plan = plans[build]
    lay = plan.layout
    n, mc, T = cons.n, cons.mc, IG.tri_size(cons.n)
    order = ["OFF_A", "OFF_WD", "OFF_WO", "OFF_SP", "OFF_LANE", "OFF_WORK"]
    if plan.shared_hessian:
        # the block's one copy of the lane-shared Hessian
        assert build in ("linear_step_fused", "ipm_shared")
        order.insert(4, "OFF_PSH")
        assert lay["OFF_LANE"] - lay["OFF_PSH"] == T
    else:
        assert "OFF_PSH" not in lay
    offs = [lay[k] for k in order] + [lay["SMEM_FLOATS"]]
    assert offs == sorted(offs) and offs[0] == 0
    assert lay["OFF_WD"] - lay["OFF_A"] == mc * lay["AS"]
    assert 4 * (lay["OFF_LANE"] - lay["OFF_SP"]) >= 2 * mc * n + mc + n
    assert lay["AS"] % 2 == 1 and lay["NP"] % 2 == 1 and lay["WS"] % 2 == 1
    assert lay["OFF_WORK"] - lay["OFF_LANE"] == plan.lanes * lay["LSTRIDE"]
    bank = plan.group if plan.group < 32 else 1
    if plan.compact:
        # x, obj and u_prev (the steps: and the freeze decision;
        # ipm_shared: no u_prev, the per-lane P's iobj in its place); the
        # Hessian and q through device scratch (but the linear step's:
        # its Hessian lane-shared, its gradient formed by the groups; and
        # ipm_shared's: its q from the caller, its Hessian lane-shared or
        # staged by the block, both triangles), the steps' plant too; the
        # work region's copy of the Hessian
        assert build in COMPACT + ONE_ROUND
        m = 1 if build in LANE_P else 0 if build == "ipm_shared" else 3
        assert plan.m == m
        assert lay["LSTRIDE"] == (n + 1 + m + (build in STEPS)) | 1
        hess = 2 * T if plan.lane_p else 0 if plan.shared_hessian else T
        assert lay["WSTRIDE"] >= hess + T + n + mc
        plant = 13 if build in STEPS else 0
        obj = 1 if build in ["step_fused"] + FRONTED else 0
        q = 0 if plan.shared_hessian or plan.lane_p else n
        assert plan.scratch_floats == (0 if plan.lane_p else hess) + q \
            + obj + plant
    else:
        assert lay["LSTRIDE"] >= n + 1 + max(T + n + plan.m, 2 * mc)
        assert lay["LSTRIDE"] % 32 == bank
        assert plan.scratch_floats == 0
    assert lay["WSTRIDE"] >= T + n + mc and lay["WSTRIDE"] % 32 == bank
    # the W ring lies over the lane and work regions (read before they
    # are staged)
    assert lay["OFF_RING"] == lay["OFF_LANE"]
    ring = plan.p * (plan.lanes * lay["NP"] + plan.lanes) if plan.p else 0
    assert lay["SLOT"] == (plan.lanes * lay["NP"] + plan.lanes
                           if plan.p else 0)
    assert lay["SMEM_FLOATS"] == max(
        lay["OFF_WORK"] + plan.groups * lay["WSTRIDE"],
        lay["OFF_RING"] + ring)


@pytest.mark.parametrize("group", [8, 16, 32])
def test_narrow_group_alternatives(plans, group):
    """The n=12 plans rebuilt at the other group sizes measured (the
    kernel A/B script, ``kernel_ab.py``, does so) stay within the block's
    shared memory; group sizes that do not divide a warp are refused."""
    cons = plans["iters2"][0]
    for plan in (dataclasses.replace(plans["iters2"][1], group=group,
                                     lanes=IG.FACTORED_THREADS // group),
                 dataclasses.replace(plans["nmpc_multipass"][1],
                                     group=group)):
        plan.check()
        assert plan.group == group and plan.smem_bytes <= IG.SMEM_LIMIT
        assert f"#define KG_GROUP {group}\n" in plan.config(cons.cols)
    with pytest.raises(ValueError):
        dataclasses.replace(plans["iters2"][1], group=12, lanes=21).check()


def test_dense_entry_table_is_AtDA(plans):
    """The dense build's A^T D A entry table (each touched lower-triangle
    entry's rows in row order) applied to the rows' nonzero values gives
    the plain dense A^T diag(D) A."""
    cons = plans["unblocked_smooth"][0]
    n = cons.n
    ent, starts, contrib = IG.dense_tables(cons.cols, n)
    assert starts[0] == 0 and starts[-1] == len(contrib)
    assert ent == sorted(set(ent))
    D = torch.rand(cons.mc, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0)) + 0.1
    Wd = cons.Wd.double()
    packed = torch.zeros(IG.tri_size(n), dtype=torch.float64)
    for e, t in enumerate(ent):
        for pc in contrib[starts[e]:starts[e + 1]]:
            c, k, l = pc & 1023, (pc >> 10) & 31, pc >> 15
            packed[t] += D[c] * Wd[c, k] * Wd[c, l]
    full = form_AtDA(cons._replace(A=cons.A.double()), D[:, None])[..., 0]
    want = torch.tensor([full[i, k].item() for k in range(n)
                         for i in range(k, n)], dtype=torch.float64)
    torch.testing.assert_close(packed, want, rtol=1e-12, atol=1e-12)
    assert [IG.tri_index(i, k, n) for k in range(n)
            for i in range(k, n)] == list(range(IG.tri_size(n)))


def _slots(defs: dict):
    """A resolver of the headers' slot #defines, names expanded (C
    integer division)."""
    def at(key):
        val = re.sub(r"[A-Z_]+", lambda t: f"({at(t.group())})",
                     defs[key]) if key.startswith("KG") else defs[key]
        return eval(val.replace("/", "//"))
    return at


@pytest.mark.parametrize("build", ONEPASS)
def test_onepass_scratch_and_lane_regions(plans, build):
    """Each one-pass plan's lane region holds x0 (the solve's x), obj and
    u_prev, and its device scratch row the packed Hessian and q, without
    overlap (the slots as csrc/nmpc_group.cuh and ipm_group.cuh define
    them); the group's copy of the Hessian fits its work region beside
    M, dx and the row vector; the wrapper's scratch holds a row for
    every lane of the grid, a ragged last block too."""
    cons, plan = plans[build]
    n, mc, m, T = cons.n, cons.mc, plan.m, IG.tri_size(cons.n)
    lay = plan.layout
    defs = dict(KM_N=str(n), KM_MC=str(mc), KM_M=str(m))
    for name in ("ipm_group.cuh", "lane_group.cuh"):
        for key, val in re.findall(r"#define (KG_(?:L_\w+|H_UP|W_PR|T)) "
                                   r"(.+)", (CSRC / name).read_text()):
            defs[key] = val.split("//")[0].strip()
    at = _slots(defs)
    assert at("KG_T") == T
    lane = sorted([(at("KG_L_X"), n, "x0"), (at("KG_L_OBJ"), 1, "obj"),
                   (at("KG_H_UP"), m, "u_prev")])
    assert lane[0][0] == 0
    for (o, w, _), (o2, _, _) in zip(lane, lane[1:]):
        assert o + w <= o2
    assert lane[-1][0] + lane[-1][1] <= lay["LSTRIDE"]
    # scratch row: [Pr: T][q: n]
    assert plan.scratch_floats == T + n
    # work region: [M: T][dx: n][vec: mc][Pr: T]
    assert at("KG_W_PR") == T + n + mc
    assert at("KG_W_PR") + T <= lay["WSTRIDE"]
    for B in (1, 1007, 65536):
        zeta = torch.zeros((6, B))
        outs = NS.outputs(SimpleNamespace(n=n, mc=mc), plan, zeta)
        assert [tuple(t.shape) for t in outs[:4]] == [(n, B), (mc, B),
                                                      (mc, B), (B,)]
        assert outs[4].numel() == plan.grid(B) * plan.lanes * (T + n)
        assert plan.grid(B) * plan.lanes >= B
    # the sweep a launch of its own, a thread a lane over the solve's grid
    # (its scratch rows are the solve's), then the solve under the plan's
    # bounds, both from the kernel's C entry
    assert plan.compact and plan.lanes == plan.threads
    kernel = build.split()[0]
    src = (CSRC / f"{kernel}.cu").read_text()
    assert re.search(r"__launch_bounds__\(KG_THREADS\)\s*" + kernel
                     + r"_sweep\(", src)
    assert f"KG_BOUNDS {kernel}_kernel(" in src
    assert re.search(rf"launch_front_solve<\w+>\({kernel}_sweep,\s*"
                     rf"{kernel}_kernel,", src)


@pytest.mark.parametrize("build", STEPS)
def test_step_scratch_and_lane_regions(plans, build):
    """Each fused step's plan: the lane region [x][obj][u_prev][keep]
    and the scratch row's sections (the bilinear step [Pr][q][obj]
    [plant], the linear one [plant], the plant [xs: nx][y: ny]
    [fin: 1] as csrc/step_group.cuh reads it) without overlap, from the
    build's #defines and the headers'; the linear step's Hessian one
    copy a block in shared memory (no per-group copy), the bilinear
    step's copied into each work region; the wrapper's scratch covering
    every lane of a ragged grid; the front launch a thread a lane before
    the solve under the plan's bounds."""
    cons, plan = plans[build]
    op = step_ops()[build]
    n, mc, m, T = cons.n, cons.mc, plan.m, IG.tri_size(cons.n)
    nx, ny = op.arm.cfg.nx, op.arm.cfg.ny
    lay = plan.layout
    defs = dict(KM_N=str(n), KM_MC=str(mc), KM_M=str(m), KM_NX=str(nx),
                KM_NY=str(ny))
    defs.update(re.findall(r"#define (KG_\w+) (\d+)\n",
                           plan.config(cons.cols)))
    for name in ("ipm_group.cuh", "lane_group.cuh", "step_group.cuh"):
        for key, val in re.findall(r"#define (KG_(?:L_\w+|H_UP|W_PR|T|"
                                   r"S_XS|S_Y|S_FIN)) (.+)",
                                   (CSRC / name).read_text()):
            defs[key] = val.split("//")[0].strip()
    at = _slots(defs)

    def disjoint(slots, end):
        slots = sorted(slots)
        assert slots[0][0] == 0
        for (o, w), (o2, _) in zip(slots, slots[1:]):
            assert o + w <= o2
        assert slots[-1][0] + slots[-1][1] <= end
    disjoint([(at("KG_L_X"), n), (at("KG_L_OBJ"), 1), (at("KG_H_UP"), m),
              (at("KG_L_KEEP"), 1)], lay["LSTRIDE"])
    want = {"step_fused": ["PR", "Q", "OBJ", "PLANT"],
            "linear_step_fused": ["PLANT"]}[build]
    assert list(plan.scratch) == want
    width = {"PR": T, "Q": n, "OBJ": 1, "PLANT": nx + ny + 1}
    secs = [(at("KG_S_" + k), width[k]) for k in want]
    disjoint(secs, at("KG_SCRATCH"))
    assert at("KG_SCRATCH") == plan.scratch_floats == sum(width[k]
                                                          for k in want)
    # the plant's slots fill its section
    plant = [(at("KG_S_XS"), nx), (at("KG_S_Y"), ny), (at("KG_S_FIN"), 1)]
    assert plant[0][0] == at("KG_S_PLANT")
    disjoint([(o - at("KG_S_PLANT"), w) for o, w in plant], nx + ny + 1)
    # the Hessian: the linear step's one block copy, the bilinear step's
    # in each group's work region after M, dx and the row vector
    assert plan.shared_hessian == (build == "linear_step_fused")
    if plan.shared_hessian:
        assert lay["WSTRIDE"] >= T + n + mc
        assert f"#define KG_OFF_PSH {lay['OFF_PSH']}\n" in plan.config(
            cons.cols)
    else:
        assert at("KG_W_PR") + T <= lay["WSTRIDE"]
    for B in (1, 1007, 262144):
        scratch = op.scratch(plan, B)
        assert scratch.numel() == plan.grid(B) * plan.lanes \
            * plan.scratch_floats
        assert plan.grid(B) * plan.lanes >= B
    assert plan.compact and plan.lanes == plan.threads
    src = (CSRC / f"{build}.cu").read_text()
    front = "step_fused_front" if build == "step_fused" \
        else "linear_step_front"
    assert re.search(r"__launch_bounds__\(KG_THREADS\)\s*" + front + r"\(",
                     src)
    assert f"KG_BOUNDS {build}_kernel(" in src
    assert re.search(rf"launch_front_solve<\w+>\(\s*{front},\s*"
                     rf"{build}_kernel,", src)


@pytest.mark.parametrize("perturbed", [False, True])
def test_linear_fold_psh_symmetric_f32(perturbed):
    """The linear step's kernel keeps one copy of Psh's lower triangle, so
    its f32 Psh must be symmetric bitwise: ``linear_fold``'s Psh on the
    committed linear model is (its f64 Psh is a rounding off symmetric,
    its f32 cast symmetric), and where an off-diagonal entry of H is off
    its mirror by more than an f32 rounding, the f32 step refuses the
    model rather than solve another QP than its plain version."""
    lmodel, lscaler, _ = load_model(LINEAR_MODEL)
    mpc = LinearKmpc(lmodel, lscaler, MpcConfig(**LINEAR_MPC), device="cpu")
    m = mpc.m
    H = np.array(mpc.H, np.float64)
    if perturbed:
        H[m + 4, m + 1] *= 1.0 + 1e-5
        mpc.H = H
    Psh = LS.linear_fold(mpc)["Psh"]
    assert np.array_equal(
        Psh, 2.0 * H[m:, m:] / max(float(np.abs(2.0 * H).max()), 1e-8))
    assert LS.symmetric_f32(Psh) != perturbed
    if perturbed:
        with pytest.raises(ValueError, match="not symmetric"):
            LS.build_linear_step_fused(mpc, Arm(ArmConfig(**BENCH_ARM),
                                                device="cpu"), lscaler)
    else:
        assert LS.symmetric_f32(step_ops()["linear_step_fused"].Psh)


def test_configs_carry_the_plan(plans, nmpc_qp):
    """Each build's configuration header defines the plan the wrapper
    launches (the kernels read their offsets and the shared-memory size
    from it), and the kernels' specs include it."""
    for build, (cons, plan) in plans.items():
        cfg = plan.config(cons.cols)
        for key in ("KG_GROUP", "KG_THREADS", "KG_LANES", "KG_ROUNDS",
                    "KG_SMEM_BYTES", "KG_OFF_LANE", "KG_LSTRIDE"):
            assert f"#define {key} " in cfg
        assert f"#define KG_SMEM_BYTES {plan.smem_bytes}\n" in cfg
        assert ("#define KG_NENT " in cfg) == (cons.band is None)
    cons = plans["iters2"][0]
    assert plans["iters2"][1].config(cons.cols) in \
        IF.kernel_spec(cons, 22).config
    q = nmpc_qp
    specs = {"nmpc_multipass": NM.kernel_spec(q),
             "nmpc_pass": NP.kernel_spec(q),
             **{"nmpc_stage " + mode: NS.kernel_spec(q, mode)
                for mode in STAGE_MODES}}
    for build, spec in specs.items():
        assert plans[build][1].config(q.cons.cols) in spec.config
    for build, op in step_ops().items():
        assert plans[build][1].config(op.cons.cols) in op.kernel_spec().config


@pytest.mark.parametrize("build", SOLVES)
def test_solve_regions(plans, build):
    """``bilin_lift``'s, ``bilin``'s and ``ipm_shared``'s plans against the
    slots their sources read (the build's #defines and the headers'): the
    lane region [x][obj][u_prev] (``ipm_shared``: [x][obj], the per-lane P
    [x][obj][iobj]); ``bilin_lift``'s and ``bilin``'s scratch row
    [Pr: T][q: n][obj: 1] and their front launch a thread a lane before
    the solve under the plan's bounds; ``ipm_shared``'s one launch, no scratch, its Hessian
    one copy a block or, per lane, the lower and strict upper triangles
    after the work region's M, dx and row vector; one block's shared memory
    within the limit and, where the plan bounds the blocks an SM, that many
    blocks' within an SM's 228 KB."""
    cons, plan = plans[build]
    n, mc, T = cons.n, cons.mc, IG.tri_size(cons.n)
    lay = plan.layout
    cfg = plan.config(cons.cols)
    src = (CSRC / ((build if build in FRONTED else "ipm_shared")
                   + ".cu")).read_text()
    defs = dict(KM_N=str(n), KM_MC=str(mc), KM_M=str(plan.m))
    defs.update(re.findall(r"#define (KG_\w+) (\d+)\n", cfg))
    for text in [(CSRC / name).read_text()
                 for name in ("ipm_group.cuh", "lane_group.cuh")] + [src]:
        for key, val in re.findall(r"#define (KG_(?:L_\w+|H_UP|W_PR|W_PU|"
                                   r"T)) (.+)", text):
            defs[key] = val.split("//")[0].strip()
    at = _slots(defs)

    def disjoint(slots, end):
        slots = sorted(slots)
        assert slots[0][0] == 0
        for (o, w), (o2, _) in zip(slots, slots[1:]):
            assert o + w <= o2
        assert slots[-1][0] + slots[-1][1] <= end
    lane = [(at("KG_L_X"), n), (at("KG_L_OBJ"), 1)]
    if build in FRONTED:
        lane.append((at("KG_H_UP"), plan.m))
    elif build in LANE_P:
        lane.append((at("KG_L_IOBJ"), 1))
    disjoint(lane, lay["LSTRIDE"])
    assert 0 < plan.smem_bytes <= IG.SMEM_LIMIT
    if plan.min_blocks:
        assert plan.min_blocks * (plan.smem_bytes + 1024) <= 228 * 1024
    for B in (1, 1007, 65536):
        assert plan.grid(B) * plan.lanes >= B > (plan.grid(B) - 1) \
            * plan.lanes
    if build in FRONTED:
        assert list(plan.scratch) == ["PR", "Q", "OBJ"]
        disjoint([(at("KG_S_PR"), T), (at("KG_S_Q"), n),
                  (at("KG_S_OBJ"), 1)], at("KG_SCRATCH"))
        assert at("KG_SCRATCH") == plan.scratch_floats == T + n + 1
        assert not plan.shared_hessian
        assert at("KG_W_PR") + T <= lay["WSTRIDE"]
        front = build + "_front"
        assert re.search(r"__launch_bounds__\(KG_THREADS\)\s*" + front
                         + r"\(", src)
        assert f"KG_BOUNDS {build}_kernel(" in src
        assert re.search(r"launch_front_solve<\w+>\(" + front + r",\s*"
                         + build + "_kernel,", src)
        return
    assert plan.scratch == () and plan.scratch_floats == 0
    assert "#define KG_SCRATCH 0\n" in cfg
    assert "KG_BOUNDS ipm_shared_kernel(" in src
    assert re.search(r"launch_solve<\w+>\(ipm_shared_kernel,", src)
    assert "launch_front_solve" not in src
    if build == "ipm_shared":
        assert plan.shared_hessian and not plan.lane_p
        assert f"#define KG_OFF_PSH {lay['OFF_PSH']}\n" in cfg
        assert lay["WSTRIDE"] >= T + n + mc
    else:
        assert plan.lane_p and not plan.shared_hessian
        assert "KG_OFF_PSH" not in cfg
        assert at("KG_W_PR") == T + n + mc
        assert at("KG_W_PU") == at("KG_W_PR") + T
        assert at("KG_W_PU") + T <= lay["WSTRIDE"]


def test_solve_configs_carry_the_plan(plans):
    """``bilin_lift``'s, ``bilin``'s and ``ipm_shared``'s builds define the
    plan their wrappers launch; the lane-shared and per-lane builds differ
    in it and in KM_LANE_P; ``bilin``'s plan is ``bilin_lift``'s."""
    lift = step_ops()["step_fused"].qp
    assert plans["bilin_lift"][1].config(lift.cons.cols) in \
        BL.kernel_spec(lift).config
    model, scaler, _ = load_model()
    bq = BilinearKmpc(model, scaler, MpcConfig(
        **{**BENCH_MPC, **BILINEAR_ROUTES["iters2"]}),
        device="cpu").bilin_qp()
    assert plans["bilin"][1] == plans["bilin_lift"][1]
    assert plans["bilin"][1].config(bq.cons.cols) in BI.kernel_spec(bq).config
    assert BI.launch_plan(bq) == BL.launch_plan(lift)
    for build in ("ipm_shared",) + tuple(LANE_P):
        cons, plan = plans[build]
        spec = IS.kernel_spec(cons, lane_p=build in LANE_P)
        assert plan.config(cons.cols) in spec.config
        assert ("#define KM_LANE_P 1\n" in spec.config) == (build in LANE_P)
    assert IS.kernel_spec(plans["ipm_shared lane-P n=12"][0]) != \
        IS.kernel_spec(plans["ipm_shared lane-P n=12"][0], lane_p=True)


@pytest.mark.parametrize("perturbed", [False, True])
def test_solve_qp_shared_psh_symmetric_f32(perturbed):
    """``ipm_shared``'s lane-shared build keeps one copy of Psh's lower
    triangle a block, so ``solve_qp_shared`` refuses a lane-shared P that
    is not symmetric in f32: the linear controller's own reduced Hessian
    Pz (``LinearKmpc.solve``) passes the check -- the f32 solve runs --
    and a Pz with one entry off its mirror by more than a rounding does
    not."""
    lmodel, lscaler, _ = load_model(LINEAR_MODEL)
    mpc = LinearKmpc(lmodel, lscaler, MpcConfig(**LINEAR_MPC), device="cpu")
    op = step_ops()["linear_step_fused"]
    X0 = np.zeros((9, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, 9)
    c = op.init_carry(X0, np.zeros((9, 2), np.float32))
    z = mpc.lift(c.ysc)
    Yr = torch.zeros((mpc.CA_t.shape[0], 1))
    f = 2.0 * mpc.CB_t.T @ (mpc.Qd_t[:, None] * (mpc.CA_t @ z - Yr))
    b = mpc.c_t[:, None] - mpc.Mc_t @ z
    Pz, fz, bz = mpc.eliminate_u0(2.0 * mpc.H_t, f, b, c.upsc)
    assert Pz.dtype == torch.float32
    assert IS.symmetric_f32(Pz * (1.0 / Pz.abs().amax()))
    if perturbed:
        Pz = Pz.clone()
        Pz[4, 1] *= 1.0 + 1e-5
        with pytest.raises(ValueError, match="not symmetric"):
            IS.solve_qp_shared(Pz, fz, mpc.constraints(), bz, iters=2)
    else:
        sol = mpc.solve(z, c.upsc, Yr[:, 0], c.upsc.repeat(mpc.Np, 1))[1]
        assert bool(sol.ok.all())


@pytest.mark.parametrize("kernel", ["nmpc_multipass", "nmpc_stage",
                                    "nmpc_pass"])
def test_wide_nmpc_plan_hands_over_rows(kernel):
    """The unblocked stack's builds (n=27, mc=108): a warp a lane; the
    lane's scratch row the pass's p = 22 projected rows [w: n][v] (no
    packed Hessian, so ``KG_S_PR`` is undefined and the group forms the
    Gram); the work region [M][dx][vec][Pr][rows], the rows after the
    Hessian (``KG_W_ROWS``); the build's header carries the section and
    the row count; the shared memory fits two blocks an SM."""
    model, scaler, _ = load_model(NONLINEAR_MODEL)
    mpc = NonlinearKmpc(model, scaler,
                        MpcConfig(**{**NMPC_MPC, "input_blocks": None}),
                        device="cpu")
    q = mpc.nmpc_qp()
    mod = {"nmpc_multipass": NM, "nmpc_stage": NS, "nmpc_pass": NP}[kernel]
    plan = mod.launch_plan(q)
    n, mc, T, p = q.n, q.mc, IG.tri_size(q.n), q.p
    assert (n, mc, p) == (27, 108, 22)
    assert plan.group == 32 and plan.compact and plan.lanes == plan.threads
    assert plan.scratch == ("W",) and plan.rows == p
    assert plan.scratch_sections == {"W": (0, p * (n + 1))}
    assert plan.scratch_floats == p * (n + 1)
    assert plan.layout["WSTRIDE"] >= 2 * T + n + mc + p * (n + 1)
    assert 2 * plan.smem_bytes <= 228 * 1024
    spec = (mod.kernel_spec(q, "roll") if kernel == "nmpc_stage"
            else mod.kernel_spec(q))
    assert "#define KG_S_W 0\n" in spec.config
    assert f"#define KG_ROWS {p}\n" in spec.config
    assert "#define KG_S_PR" not in spec.config
    # the narrow (blocked) builds keep the Gram in the sweep's thread
    blocked = NonlinearKmpc(model, scaler, MpcConfig(**NMPC_MPC),
                            device="cpu").nmpc_qp()
    assert mod.launch_plan(blocked).scratch == ("PR", "Q")
