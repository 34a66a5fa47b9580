"""The controller knobs the port takes since the harness slice, against
the JAX package on the same inputs, f64 on the CPU:

- the dual stage shift (``dual_shift_perm_blocked``, ``dual_shift_perm``,
  ``_extend_dual_shift``, ``_shift_lam``; kmpc.py:185-237, 378-393):
  the permutations and each controller's extended index equal JAX's;
- state bounds (``state_constraint_rows``, kmpc.py:240-265);
- ``LinearKmpc`` with the dual warm start (and the shift), blocked and
  unblocked with state bounds (L = [F; E Bbig], M = [0; E Abig],
  kmpc.py:461-467): its host constants and ``solve`` against the JAX
  controller's (pure f64 in both packages: 1e-9; unblocked, the
  multipliers are not unique and only the plans are held);
- ``BilinearKmpc`` unblocked with state bounds (a Hessian and rows a
  lane, ``ops/qp.py:solve_qp_lane_A``, JAX's ``solve_qp(shared_A=False)``
  route): ``solve`` against ``bilinear_solve_pure`` fed the port's f64
  values where the JAX controller holds f32 casts (parity note 1 of
  ROADMAP.md §3), one pass and two: the plans within 1e-9;
- the bilinear lift-fused route with the shift: the shifted warm start
  of a short live loop against JAX's (the f32 generators: 1e-6);
- the lasso sweep at ``bilinear_iters=2`` on the six committed
  candidates against the JAX sweep: alive equal, err within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koopman_realizations_tpu.config import ArmConfig as JArmConfig
from koopman_realizations_tpu.control import kmpc as JK
from koopman_realizations_tpu.models.arm import Arm as JArm
from koopman_realizations_tpu.ops.qp import _solve_qp_impl
from koopman_realizations_tpu.workflows.lasso_sweep import (
    lasso_sweep_closed_loop as jax_sweep,
)

from koopman_realizations_torch.config import ArmConfig, MpcConfig
from koopman_realizations_torch.control import kmpc as TK
from koopman_realizations_torch.control.kmpc import BilinearKmpc, LinearKmpc
from koopman_realizations_torch.control.ksim import Ksim, _Loop
from koopman_realizations_torch.models.arm import Arm
from koopman_realizations_torch.ops.qp import solve_qp_lane_A
from koopman_realizations_torch.utils.checkpoint import (
    LINEAR_MODEL,
    load_model,
)
from koopman_realizations_torch.utils.trajectories import blockM_reference
from koopman_realizations_torch.workflows.lasso_sweep import (
    lasso_sweep_closed_loop,
)

from test_torch_oracle import (
    BENCH_ARM,
    KNOB_LASSO,
    KNOB_PATHS,
    LASSO_SWEEP,
    bench_X0,
    bilinear_lanes,
    blockM_y,
    jax_knob_sim,
    jax_lasso_candidates_models,
    jax_model,
    one_thread,  # noqa: F401  (the fixture of pytestmark)
    port_lasso_candidates,
)

pytestmark = pytest.mark.usefixtures("one_thread")

LINEAR_KNOBS = ("linear_dual_warm", "linear_dual_shift",
                "linear_unblocked_sb")
BILINEAR_KNOBS = ("bilinear_dual_shift", "bilinear_unblocked_sb")


def cfg_of(name, **over) -> MpcConfig:
    return MpcConfig(**{**KNOB_PATHS[name][1], **over})


@functools.lru_cache(maxsize=None)
def port(name, **over):
    kind = KNOB_PATHS[name][0]
    model, scaler, _ = load_model(LINEAR_MODEL) if kind == "linear" \
        else load_model()
    cls = LinearKmpc if kind == "linear" else BilinearKmpc
    return cls(model, scaler, cfg_of(name, **over), device="cpu",
               dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def jax_ctrl(name, **over):
    kind = KNOB_PATHS[name][0]
    model, scaler = jax_model(kind)
    return JK.make_kmpc(model, scaler, JK.MpcConfig(
        **{**KNOB_PATHS[name][1], **over}))


@pytest.mark.parametrize("knobs", [
    dict(), dict(input_blocks=None),
    dict(input_blocks=None, input_smoothConst=0.1),
    dict(input_bounds=None), dict(input_slopeConst=None, input_blocks=None)])
def test_dual_shift_permutations_match_jax(knobs):
    base = {**KNOB_PATHS["bilinear_dual_shift"][1], **knobs}
    cfg, jcfg = MpcConfig(**base), JK.MpcConfig(**base)
    m, Np = 3, cfg.horizon
    if cfg.input_blocks is not None:
        nf = len(cfg.input_blocks)
        np.testing.assert_array_equal(
            TK.dual_shift_perm_blocked(cfg, m, nf),
            JK.dual_shift_perm_blocked(jcfg, m, nf))
    np.testing.assert_array_equal(TK.dual_shift_perm(cfg, m, Np),
                                  JK.dual_shift_perm(jcfg, m, Np))


@pytest.mark.parametrize("name", ("linear_dual_shift",
                                  "linear_unblocked_sb",
                                  "bilinear_dual_shift",
                                  "bilinear_unblocked_sb"))
def test_controllers_extend_the_shift_as_jax(name):
    """Each controller's dual shift over all its rows (state-bound rows
    keep their own multiplier) equals JAX's ``_dual_shift``, and its row
    count ``n_con``; ``shift_lam`` is that row gather."""
    p = port(name, qp_dual_shift=True)
    j = jax_ctrl(name, qp_dual_shift=True)
    assert p.n_con == j.n_con
    np.testing.assert_array_equal(p.shift_idx.numpy(),
                                  np.asarray(j._dual_shift))
    lam = torch.arange(p.n_con, dtype=torch.float64)[:, None].repeat(1, 2)
    np.testing.assert_array_equal(p.shift_lam(lam)[:, 0].numpy(),
                                  np.asarray(j._dual_shift))
    assert port(name, qp_dual_shift=False).shift_lam(lam) is lam


def test_state_constraint_rows_match_jax():
    cfg = cfg_of("linear_unblocked_sb")
    _, scaler, _ = load_model(LINEAR_MODEL)
    _, jscaler = jax_model("linear")
    E, c = TK.state_constraint_rows(cfg, 6, 28, cfg.horizon, scaler)
    jE, jc = JK.state_constraint_rows(JK.MpcConfig(
        **KNOB_PATHS["linear_unblocked_sb"][1]), 6, 28, cfg.horizon, jscaler)
    np.testing.assert_array_equal(E, jE)
    np.testing.assert_allclose(c, jc, rtol=0, atol=1e-14)
    assert E.shape == (2 * 6 * (cfg.horizon - 1), 28 * (cfg.horizon + 1))


def _linear_lanes(p, B, seed):
    """``bilinear_lanes``'s recipe on the linear controller: lifted states
    of random arm states, previous inputs inside the bounds, a near-held
    plan, positive multipliers (original units) and reference windows of
    random blockM steps (unscaled for JAX, scaled for the port), f64
    lanes-minor."""
    rng = np.random.default_rng(seed)
    arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
    X = np.zeros((6, B))
    X[:3] = rng.uniform(-0.4, 0.4, (3, B))
    X[3:] = rng.normal(0, 0.3, (3, B))
    zeta = p.scaler.y_down(arm.get_y(torch.from_numpy(X)), axis=0)
    up = torch.from_numpy(rng.uniform(-0.6, 0.6, (3, B)))
    U = up.repeat(p.Np, 1) + torch.from_numpy(
        rng.normal(0, 0.01, (p.Np * 3, B)))
    lam = torch.from_numpy(np.exp(rng.normal(-1.0, 1.0, (p.n_con, B))))
    ref = p.scaler.ref_down(blockM_y(), p.proj_idx)
    ks = rng.integers(0, ref.shape[0] - p.Np - 1, B)
    refhor = np.stack([ref[k:k + p.Np + 1] for k in ks])
    Yr = torch.from_numpy(refhor.reshape(B, -1).T.copy())
    return p.lift(zeta.double()), up, U, lam, refhor, Yr


def _linear_loop_lanes(p, B, at):
    """The port's own closed loop (f64, the bench's arm and blockM, B
    lanes spread over +-0.2 rad) after ``at`` steps: the next solve's
    lifted state, previous input, plan, multipliers and reference window
    (rows for JAX, flat for the port), as ``_linear_lanes``."""
    sim = Ksim(Arm(ArmConfig(**BENCH_ARM), device="cpu"), p, device="cpu")
    ref = blockM_reference()
    X0 = np.zeros((B, 6))
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    loop = _Loop(sim, at + 3, sim.reference_windows(ref, at + 3),
                 sim._ref_rows(sim.prep_ref(ref), at + 3), (), X0,
                 np.zeros((B, 2)))
    for k in range(at):
        loop.step(k)
    Yr = loop.windows[at]
    refhor = np.tile(Yr.reshape(p.Np + 1, -1).numpy(), (B, 1, 1))
    return (p.lift(loop.ysc), loop.upsc, loop.U_plan, loop.lam, refhor,
            Yr[:, None].expand(-1, B))


def _bound_rows_at(p, args, U):
    """How many state-bound rows each lane's plan U (Np*m, B) holds at
    their bound (slack below 1e-8 in row units) in the QP of ``args``
    (``LinearKmpc.qp_args``)."""
    cons, b = args[0], args[3]
    sb = slice(p.n_con - 2 * p.n * (p.Np - 1), p.n_con)
    return ((b - cons.A @ U[p.m:])[sb] < 1e-8).sum(0).numpy()


@pytest.mark.parametrize("name", LINEAR_KNOBS)
def test_linear_knob_solve_matches_jax(name):
    """The host constants (L, M, c, H; 1e-12) and ``solve`` with warm
    duals (shifted where the knob asks) against the JAX controller on 8
    lanes: plans within 1e-9, multipliers 1e-9 relative, ok equal.  The
    state-bound knob takes its own loop's lanes after 40 steps, where its
    capped bound binds on every lane: as many rows at their bound in the
    port's plan as in JAX's, and some."""
    p, j = port(name), jax_ctrl(name)
    for k in ("L", "Mc", "c", "H", "CA", "CB"):
        np.testing.assert_allclose(getattr(p, k), np.asarray(getattr(j, k)),
                                   rtol=0, atol=1e-12, err_msg=k)
    assert p.band == j._band
    sb = p.cfg.state_bounds is not None
    z, up, U, lam, refhor, Yr = _linear_loop_lanes(p, 8, 40) if sb \
        else _linear_lanes(p, 8, 5)
    Up, sol = p.solve(z, up, Yr, U, lam)
    jU, jok, jlam = jax.vmap(lambda zl, ul, rl, Ul, ll: j.solve(
        zl, ul, rl, U_init=Ul.reshape(p.Np, p.m), lam_init=ll))(
        *(jnp.asarray(a) for a in (z.T.numpy(), up.T.numpy(), refhor,
                                   U.T.numpy(), lam.T.numpy())))
    assert sol.ok.all() and (sol.ok.numpy() == np.asarray(jok)).all()
    np.testing.assert_allclose(Up.T.numpy(), np.asarray(jU).reshape(8, -1),
                               rtol=0, atol=1e-9)
    if sb:
        args = p.qp_args(z, up, Yr, U, lam)[0]
        act = _bound_rows_at(p, args, Up)
        jact = _bound_rows_at(p, args, torch.from_numpy(
            np.asarray(jU).reshape(8, -1).T.copy()))
        print(f"{name}: state-bound rows at their bound a lane {act} "
              f"(JAX {jact})")
        assert act.sum() > 0 and (act == jact).all()
    if p.blocked:
        np.testing.assert_allclose(sol.lam.T.numpy(), np.asarray(jlam),
                                   rtol=1e-9, atol=1e-9)
    # unblocked, a stage's bound and slope rows are active together: the
    # multipliers are not unique, and the two f64 orderings freeze on
    # different points of the optimal face (0.154 against 0.117 on one
    # row, measured), so only the plans are held there


def _jax_sb_consts(p, j):
    """The JAX bilinear controller's constants with the port's f64 values
    in place of its f32 products (A's powers, the fused generators)."""
    c = dict(j.consts())
    A = np.asarray(p.model.A, np.float64)
    Np, NL, n = p.Np, p.NL, p.n
    pw = [np.eye(NL)]
    for _ in range(Np):
        pw.append(pw[-1] @ A)
    EA = np.stack([w[:n] for w in pw])
    EAt = TK.toeplitz_stack(EA, Np)
    Bm = np.asarray(p.model.B, np.float64)
    g = p.gens_host
    c.update(A=A, Bm=Bm, PA=g["PA"], PAt=g["PAt"], PG=g["PG"], EA=EA,
             EAt=EAt, EG=np.einsum("ijrb,bmq->irjmq", EAt, Bm)
             .reshape(-1, NL))
    return {k: jnp.asarray(v) for k, v in c.items()}


@pytest.mark.parametrize("iters", [1, 2])
def test_bilinear_state_bound_solve_matches_jax(iters):
    """``BilinearKmpc.solve`` unblocked with state bounds (a dense P and
    rows a lane, ``solve_qp_lane_A``) against ``bilinear_solve_pure``'s
    ``has_sb`` branch on 6 lanes, cold and warm duals: plans within
    1e-9, ok equal."""
    name = "bilinear_unblocked_sb"
    p = port(name, bilinear_iters=iters)
    j = jax_ctrl(name, bilinear_iters=iters)
    assert not p.lift_fused and p.n_con == j.n_con == 216
    z, up, U, lam, refhor, sqYr = bilinear_lanes(p, 6, 7)
    c = _jax_sb_consts(p, j)
    for warm in (False, True):
        Up, sol = p.solve(z, up, sqYr, U, lam if warm else None)

        def one(zl, ul, rl, Ul, ll):
            return JK.bilinear_solve_pure(
                c, zl, ul, rl, Ul.reshape(p.Np, p.m), Np=p.Np, m=p.m,
                n=p.n, nproj=p.nproj, qp_iters=p.cfg.qp_iters, iters=iters,
                backend="jax", band=j._band, lam_init=ll if warm else None)

        jU, jok, jlam = jax.vmap(one)(*(jnp.asarray(a) for a in (
            z.T.numpy(), up.T.numpy(), refhor, U.T.numpy(),
            lam.T.numpy())))
        assert (sol.ok.numpy() == np.asarray(jok)).all() and sol.ok.any()
        np.testing.assert_allclose(Up.T.numpy(),
                                   np.asarray(jU).reshape(6, -1), rtol=0,
                                   atol=1e-9)
        # the unblocked stack's multipliers are not unique (see the
        # linear knobs): only the plans are held


def test_lane_A_solve_matches_jax():
    """``solve_qp_lane_A`` (a Hessian and rows a lane) against the JAX
    ``_solve_qp_impl`` with ``shared_A=False`` under vmap, on the state-
    bound QPs of 5 lanes, warm primal, cold and warm duals: 1e-9."""
    p = port("bilinear_unblocked_sb")
    z, up, U, lam, _, sqYr = bilinear_lanes(p, 5, 11)
    beta = (p.Bm_t @ z).reshape(p.NL, p.m, -1)
    P, q, A, b = p.state_bound_qp(z, up, sqYr,
                                  beta.expand(p.Np, *beta.shape))
    x0 = p.warm_start(U)
    for l0 in (None, lam):
        sol = solve_qp_lane_A(P, q, A, b, iters=12, x0=x0, lam0=l0)
        f = jax.vmap(lambda Pl, ql, Al, bl, xl, ll: _solve_qp_impl(
            Pl, ql, Al, bl, 12, xl, False, None if l0 is None else ll))
        js = f(*(jnp.asarray(a.permute(2, 0, 1).numpy() if a.ndim == 3
                             else a.T.numpy())
                 for a in (P, q, A, b, x0, lam)))
        assert (sol.ok.numpy() == np.asarray(js.ok)).all()
        np.testing.assert_allclose(sol.x.T.numpy(), np.asarray(js.x),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(sol.lam.T.numpy(), np.asarray(js.lam),
                                   rtol=1e-9, atol=1e-9)


def test_bilinear_shift_on_the_lift_fused_route():
    """The lift-fused controller with ``qp_dual_shift``: its solve is the
    unshifted one from the gathered duals, it stays off the fused step
    (as in JAX, ksim.py:428), and a short live loop (B=4 x 30) keeps JAX's
    tracked outputs within 1e-6 (the JAX generators are f32)."""
    name = "bilinear_dual_shift"
    p = port(name)
    assert p.lift_fused and p.dual_shift is not None
    z, up, U, lam, _, sqYr = bilinear_lanes(p, 4, 13)
    zeta = z[:p.meta.nzeta]
    a = p.solve(zeta, up, sqYr, U, lam)
    b = port(name, qp_dual_shift=False).solve(zeta, up, sqYr, U,
                                              lam[p.shift_idx])
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
    sim = Ksim(arm, p, device="cpu")
    assert not sim.fused_step_eligible()
    B, steps = 4, 30
    out = sim.batched_runner(blockM_reference(), steps)(
        bench_X0(B), np.zeros((B, 2)))
    jsim, _ = jax_knob_sim(name)
    jout = jax.block_until_ready(jsim.batched_runner(
        blockM_y(), steps=steps, record=("Yp", "alive"))(
            bench_X0(B), np.zeros((B, 2), np.float32)))
    assert out["alive"].all() and np.asarray(jout["alive"]).all()
    np.testing.assert_allclose(out["Yp"].numpy(), np.asarray(jout["Yp"]),
                               rtol=0, atol=1e-6)


def test_linear_knobs_stay_off_the_fused_step():
    """The fused linear step keeps requiring a blocked stack with cold
    duals (JAX ksim.py:429-436)."""
    arm = Arm(ArmConfig(**BENCH_ARM), device="cpu")
    model, scaler, _ = load_model(LINEAR_MODEL)
    for name in LINEAR_KNOBS:
        mpc = LinearKmpc(model, scaler, cfg_of(name), device="cpu")
        assert not Ksim(arm, mpc, device="cpu").fused_step_eligible()
    cold = LinearKmpc(model, scaler, cfg_of("linear_dual_warm",
                                            qp_dual_warm=False),
                      device="cpu")
    assert Ksim(arm, cold, device="cpu").fused_step_eligible()


def test_lasso_sweep_relinearized_matches_jax():
    """The closed-loop lasso sweep at ``bilinear_iters=2`` (every
    candidate's second pass about its own re-rolled trajectory, warm from
    the first pass's duals) on the six committed candidates, f64, 20
    steps, against the JAX sweep on the same models: alive equal, each
    candidate's err within 1e-5."""
    import types
    steps = 20
    r = LASSO_SWEEP
    cands, scaler = port_lasso_candidates()
    mcfg = {**r["mpc"], **KNOB_LASSO}
    out = lasso_sweep_closed_loop(
        types.SimpleNamespace(candidates=cands, scaler=scaler),
        Arm(ArmConfig(**r["arm"]), device="cpu"), MpcConfig(**mcfg),
        blockM_reference(), steps=steps, device="cpu", dtype=torch.float64)
    jout = jax_sweep(jax_lasso_candidates_models(),
                     JArm(JArmConfig(**r["arm"])), JK.MpcConfig(**mcfg),
                     blockM_y(), steps=steps)
    np.testing.assert_array_equal(out["alive"], np.asarray(jout["alive"]))
    np.testing.assert_allclose(out["err"], np.asarray(jout["err"]), rtol=0,
                               atol=1e-5)


def test_knob_refs_are_the_recipe_chip_smoke_runs():
    """``assets/knob_refs.json`` (``--write-knob-refs``) carries each knob
    path's controller as ``KNOB_PATHS`` builds it and the sweep's as
    ``KNOB_LASSO`` on ``LASSO_SWEEP``; chip_smoke.py's phase RN reads its
    configurations from there."""
    import json

    from test_torch_oracle import KNOB_REFS
    refs = json.loads(KNOB_REFS.read_text())
    assert set(refs["paths"]) == set(KNOB_PATHS)
    for name, r in refs["paths"].items():
        cfg = cfg_of(name)
        for k, v in r["config"].items():
            if hasattr(cfg, k):
                mine = getattr(cfg, k)
                mine = [list(x) if isinstance(x, tuple) else x
                        for x in mine] if isinstance(mine, tuple) else mine
                assert mine == v, (name, k)
        assert len(r["err_mean"]) == refs["B"] == 16
    lr = refs["lasso"]
    assert lr["config"]["bilinear_iters"] == KNOB_LASSO["bilinear_iters"]
    assert len(lr["candidates"]) == len(LASSO_SWEEP["lasso"])


def test_lost_lanes_solve_as_jax():
    """The three QPs that the card's kernel lost in the cold state-bound
    loop (``assets/cold_lost_lanes.npz``: ``chip_smoke.py --measure
    cold-lanes``, its wide bounds, cold duals, 24 iterations): the plain
    version in f32 and f64 on the CPU solves each at 24 and at 48
    iterations exactly where JAX's ``solve_qp`` does (f32, x64; ok equal,
    every one solved).  The kernel's loss is its f32 path after
    convergence (PERF.md §6), not a QP that f32 cannot solve."""
    import json

    from koopman_realizations_torch.ops.kernels.ipm_shared import (
        ipm_shared_plain,
    )
    from koopman_realizations_torch.ops.qp import (
        Constraints,
        ok_mask,
        qp_constants,
    )
    from test_torch_oracle import LOST_LANES
    d = np.load(LOST_LANES)
    h = json.loads(str(d["header"]))
    tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, list) else v
    model, scaler, _ = load_model(LINEAR_MODEL)
    cfg = MpcConfig(**{k: tup(v) for k, v in h["config"].items()})
    cons = LinearKmpc(model, scaler, cfg, device="cpu").constraints()
    np.testing.assert_array_equal(cons.A.numpy(), d["A"])
    for dt, key in ((torch.float32, "f32"), (torch.float64, "f64")):
        c = Constraints(*(t.to(dt) if torch.is_tensor(t) else t
                          for t in cons))
        P, q, b, x0 = (torch.from_numpy(d[k]).to(dt)
                       for k in ("Psh", "q", "b", "x0"))
        tol, gap_sane = qp_constants(dt)[2:]
        for k in (h["iters"], 2 * h["iters"]):
            x, s, lam = ipm_shared_plain(c, P, q, b, x0, k,
                                         h["slack_floor"])
            ok = ok_mask(c, b, x, s, lam, tol, gap_sane)[0]
            assert ok.tolist() == h["jax"][key][str(k)]["ok"] \
                == [True] * q.shape[1], (key, k)
