"""The bilinear assembly's live-row table (``ops/qp.py:generator_live``,
``ops/kernels/bilin_lift.py:live_config``): which rows of the lane-shared
generator stack are not all zero, the table from which
``csrc/kmpc_device.cuh:assemble`` leaves the structural zeros out of the
assembly and the factored Gram of ``bilin_lift``, ``step_fused`` and
``bilin``.  On the committed bilinear model, for the lift-fused QP and
for iterated relinearization's blocked stack, and on the loaded-arm
model for the loaded controller's blocked stack (``bilin`` at NL=42): the table is the stack's
exact-zero rows, it is the pattern the move blocks imply (a W entry
lives where its move group's first input reaches the stage, a CB0 row
from stage 1 on), and it is part of each build's configuration, so the
build cache keys on it.  Pure Python: the kernels run only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control.kmpc import BilinearKmpc
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.kernels import bilin as BI
from koopman_realizations_torch.ops.kernels import bilin_lift as BL
from koopman_realizations_torch.ops.kernels import step_fused as SF
from koopman_realizations_torch.ops.qp import generator_live
from koopman_realizations_torch.utils.checkpoint import (
    LOADED_BILINEAR_MODEL,
    load_model,
)

from test_torch_oracle import BENCH_ARM, BENCH_MPC
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

QPS = ["lift-fused", "blocked", "loaded"]
# zero rows of the stack (W, CB0, v) of each QP, and each part's rows: the
# bench model's (n=12, m=3) and the loaded-arm model's (n=8, m=2)
ZERO_ROWS = {"lift-fused": ((90, 264), (6, 66), (0, 22)),
             "blocked": ((90, 264), (6, 66), (0, 22)),
             "loaded": ((60, 176), (4, 44), (0, 22))}


@pytest.fixture(scope="module")
def qps():
    """The bench controller's lift-fused QP and iterated relinearization's
    blocked QP (f32, on the CPU), with their controllers."""
    model, scaler, _ = load_model()
    lift = BilinearKmpc(model, scaler, MpcConfig(**BENCH_MPC), device="cpu")
    blocked = BilinearKmpc(model, scaler, MpcConfig(
        **{**BENCH_MPC, "bilinear_iters": 2}), device="cpu")
    lmodel, lscaler, _ = load_model(LOADED_BILINEAR_MODEL)
    loaded = BilinearKmpc(lmodel, lscaler, MpcConfig(
        **{**BENCH_MPC, "proj_idx": (2, 3), "cost_input": (3e-3, 2e-3),
           "qp_iters": 10, "qp_dual_warm": False}), device="cpu")
    return {"lift-fused": (lift, lift.lift_qp()),
            "blocked": (blocked, blocked.bilin_qp()),
            "loaded": (loaded, loaded.bilin_qp())}


def _parts(qp):
    """The stack's (W (p, n), CB0 (m, p), v (p,)) rows: all zero or not."""
    p, n, m = qp.p, qp.n, qp.m
    nz = (qp.gens != 0).any(1).numpy()
    return (nz[:p * n].reshape(p, n), nz[p * n:(n + m) * p].reshape(m, p),
            nz[(n + m) * p:])


@pytest.mark.parametrize("kind", QPS)
def test_live_table_is_the_stacks_zero_rows(qps, kind):
    """Bit i of stage row r's word is W[r, i]'s row, bit n + j CB0[r, j]'s,
    bit n + m v[r]'s: set exactly where the row has a nonzero.  On the
    committed model 90 of the 264 W rows are zero (the stages no move
    reaches), 6 of the 66 CB0 rows (stage 0), none of the 22 v rows; on
    the loaded-arm model (NL=42, m=2: n=8) 60 of 176 and 4 of 44."""
    _, qp = qps[kind]
    W, H, P = _parts(qp)
    n, m = qp.n, qp.m
    assert len(qp.live) == qp.p
    for r, word in enumerate(qp.live):
        assert [bool(word >> i & 1) for i in range(n)] == W[r].tolist()
        assert [bool(word >> (n + j) & 1) for j in range(m)] \
            == H[:, r].tolist()
        assert bool(word >> (n + m) & 1) == P[r]
        assert word >> (n + m + 1) == 0
    zw, zh, zp = ZERO_ROWS[kind]
    assert ((~W).sum(), W.size) == zw
    assert ((~H).sum(), H.size) == zh
    assert ((~P).sum(), P.size) == zp
    assert qp.live == generator_live(qp.gens, qp.p, n, m)


@pytest.mark.parametrize("kind", QPS)
def test_live_table_is_the_move_blocks_pattern(qps, kind):
    """The zeros are structure, not data: stage row r (stage i = r //
    nproj) sees move c where the first input of c's move group (stage
    start + 1; u_prev is stage 0) comes before stage i, and CB0 (u_prev)
    from stage 1 on; every row is weighted (q > 0)."""
    mpc, qp = qps[kind]
    m, nproj = qp.m, len(mpc.proj_idx)
    starts = np.concatenate([[0], np.cumsum(mpc.cfg.input_blocks)[:-1]])
    first = np.repeat(starts + 1, m)                  # per move column
    stage = np.arange(qp.p) // nproj
    assert (mpc.q_diag > 0).all()
    W, H, P = _parts(qp)
    assert np.array_equal(W, first[None, :] < stage[:, None])
    assert np.array_equal(H, np.broadcast_to(stage >= 1, H.shape))
    assert P.all()


@pytest.mark.parametrize("kind", QPS)
def test_live_config_runs(qps, kind):
    """The build's table: for W, CB0 and v the runs of consecutive stage
    rows with one mask, in stage order, covering every row once, each
    run's mask that of its rows."""
    _, qp = qps[kind]
    cfg = BL.live_config(qp.live, qp.n, qp.m)
    for part, shift, width in (("W", 0, qp.n), ("H", qp.n, qp.m),
                               ("P", qp.n + qp.m, 1)):
        runs = eval(cfg.split(f"#define KM_LIVE_{part} ")[1].split("\n")[0]
                    .replace("u", "").replace("{", "[").replace("}", "]"))
        assert f"#define KM_NLIVE_{part} {len(runs)}\n" in cfg
        assert runs[0][0] == 0 and runs[-1][1] == qp.p
        for (a, b, mask), nxt in zip(runs, runs[1:] + [None]):
            assert a < b and (nxt is None or (nxt[0] == b
                                              and nxt[2] != mask))
            for r in range(a, b):
                assert (qp.live[r] >> shift) & ((1 << width) - 1) == mask
    # the lift-fused W: no stage row reached before stage 2, then one,
    # two, three and four move groups
    if kind == "lift-fused":
        assert "#define KM_LIVE_W {{0u, 4u, 0u}, {4u, 6u, 7u}, {6u, 8u, " \
            "63u}, {8u, 12u, 511u}, {12u, 22u, 4095u}}\n" in cfg


def test_live_table_enters_the_build_key(qps):
    """Each build that assembles against the stack (``bilin_lift``,
    ``step_fused``, ``bilin``) carries the table in its configuration,
    so the build cache (hashed from it) keys on it: another table is
    another build."""
    lift, lqp = qps["lift-fused"]
    _, bqp = qps["blocked"]
    op = SF.build_step_fused(lift, Arm(ArmConfig(**BENCH_ARM), device="cpu"),
                             lift.scaler)
    for spec, qp in ((BL.kernel_spec(lqp), lqp), (op.kernel_spec(), lqp),
                     (BI.kernel_spec(bqp), bqp)):
        assert BL.live_config(qp.live, qp.n, qp.m) in spec.config
    dense = lqp._replace(live=tuple((1 << (lqp.n + lqp.m + 1)) - 1
                                    for _ in lqp.live))
    assert "#define KM_LIVE_W {{0u, 22u, 4095u}}\n" in \
        BL.kernel_spec(dense).config
    assert BL.kernel_spec(dense) != BL.kernel_spec(lqp)
    assert _build._digest(BL.kernel_spec(dense)) \
        != _build._digest(BL.kernel_spec(lqp))
    # the table is the stack's, made on the host with the operands
    gens = lqp.gens.clone()
    gens[5 * lqp.n + 11] = 0.0          # W[5, 11]: already zero
    gens[20 * lqp.n + 3] = 0.0          # W[20, 3]: live until now
    live = generator_live(gens, lqp.p, lqp.n, lqp.m)
    assert live[5] == lqp.live[5] and live[20] == lqp.live[20] & ~(1 << 3)
    assert torch.equal(lqp.gens[5 * lqp.n + 11], gens[5 * lqp.n + 11])
