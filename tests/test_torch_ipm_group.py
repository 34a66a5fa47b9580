"""The cooperative interior point's launch plan (``ops/kernels/
ipm_group.py``) for every build that uses it: ``ipm_factored``'s four
(iterated relinearization n=12/mc=48, its q0 build on the NMPC's 'linear'
update, the unblocked stack n=27/mc=108, with smoothness rows
n=27/mc=156 dense) and ``nmpc_multipass``'s.  Pure Python: the group size,
lanes per block, the grid over B with a ragged tail, the shared-memory
layout within the H100's 227 KB a block, and the dense A^T D A entry table
against the plain dense form.  The kernels themselves run only on the
card (tests/test_torch_cuda.py)."""

import dataclasses

import pytest
import torch

from koopman_realizations_torch.config import MpcConfig
from koopman_realizations_torch.control.kmpc import (
    BilinearKmpc,
    NonlinearKmpc,
)
from koopman_realizations_torch.ops.kernels import ipm_factored as IF
from koopman_realizations_torch.ops.kernels import ipm_group as IG
from koopman_realizations_torch.ops.kernels import nmpc_multipass as NM
from koopman_realizations_torch.ops.qp import form_AtDA
from koopman_realizations_torch.utils.checkpoint import (
    NONLINEAR_MODEL,
    load_model,
)

from test_torch_oracle import BENCH_MPC, BILINEAR_ROUTES, NMPC_MPC

# (n, mc, band, group) of each build
EXPECTED = {"iters2": (12, 48, 3, IG.NARROW_GROUP),
            "unblocked": (27, 108, 3, 32),
            "unblocked_smooth": (27, 156, None, 32),
            "q0": (12, 48, 3, IG.NARROW_GROUP),
            "nmpc_multipass": (12, 48, 3, IG.NMPC_GROUP)}


@pytest.fixture(scope="module")
def plans():
    """Each build's constraints and plan, as its wrapper makes it."""
    model, scaler, _ = load_model()
    out = {}
    for name, knobs in BILINEAR_ROUTES.items():
        m = BilinearKmpc(model, scaler, MpcConfig(**{**BENCH_MPC, **knobs}),
                         device="cpu")
        out[name] = (m.constraints(), IF.launch_plan(m.constraints(), m.p))
    nmodel, nscaler, _ = load_model(NONLINEAR_MODEL)
    nm = NonlinearKmpc(nmodel, nscaler, MpcConfig(**NMPC_MPC), device="cpu")
    q = nm.nmpc_qp()
    out["q0"] = (q.cons, IF.launch_plan(q.cons, q.p))
    out["nmpc_multipass"] = (q.cons, NM.launch_plan(q))
    return out


@pytest.mark.parametrize("build", list(EXPECTED))
def test_plan_of_each_build(plans, build):
    """Group size from (n, mc), lanes per block, rounds, grid over B with
    a ragged tail, and the shared memory within one block's 227 KB."""
    cons, plan = plans[build]
    n, mc, band, group = EXPECTED[build]
    assert (cons.n, cons.mc, cons.band) == (n, mc, band)
    assert plan.group == group == (IG.NMPC_GROUP if build == "nmpc_multipass"
                                   else IG.choose_group(n, mc))
    assert plan.threads % plan.group == 0
    if build == "nmpc_multipass":
        # a lane a thread in the sweep; threads // group lanes a round
        assert plan.lanes == plan.threads == IG.NMPC_THREADS
        assert plan.rounds == plan.group
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
    offs = [lay[k] for k in order] + [lay["SMEM_FLOATS"]]
    assert offs == sorted(offs) and offs[0] == 0
    assert lay["OFF_WD"] - lay["OFF_A"] == mc * lay["AS"]
    assert 4 * (lay["OFF_LANE"] - lay["OFF_SP"]) >= 2 * mc * n + mc + n
    assert lay["AS"] % 2 == 1 and lay["NP"] % 2 == 1 and lay["WS"] % 2 == 1
    assert lay["OFF_WORK"] - lay["OFF_LANE"] == plan.lanes * lay["LSTRIDE"]
    bank = plan.group if plan.group < 32 else 1
    if plan.compact:
        # x, obj and u_prev; the Hessian and q through device scratch
        assert build == "nmpc_multipass" and plan.m == 3
        assert lay["LSTRIDE"] == (n + 1 + 3) | 1
        assert lay["WSTRIDE"] >= 2 * T + n + mc
        assert plan.scratch_floats == T + n
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


def test_configs_carry_the_plan(plans):
    """Each build's configuration header defines the plan the wrapper
    launches (the kernels read their offsets and the shared-memory size
    from it), and the two kernels' specs include it."""
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
