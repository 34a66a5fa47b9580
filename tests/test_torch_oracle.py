"""JAX-side oracle for the PyTorch port's tests, and the model asset.

The port (``koopman_realizations_torch``) never imports JAX; its tests hold
it against the JAX package on the same inputs.  This module builds the JAX
side once per process -- the bench controller, the arm plant, the closed
loop -- from the committed model asset, and other ``tests/test_torch_*.py``
files import these helpers.

The three model assets are the JAX trainer's output on the in-repo
generated corpus (the MATLAB datafile the bench was tuned on is not part
of the repo):

    python tests/test_torch_oracle.py --write-asset [KIND ...]

regenerates the named ones (all three without a name):
``generate(15, 60.0, n_val=5, seed=0)`` -> ``Ksysid`` poly-3 with PCA,
f32 -> ``save_model``, once bilinear (``arm3_bilinear_poly3.npz``, the
bench controller ``BENCH_MPC``), once linear (``arm3_linear_poly3.npz``,
the linear controller ``LINEAR_MPC``) and once nonlinear with PCA at
99.99 % explained variance (``arm3_nonlinear_poly3.npz``, the SQP NMPC
controller ``NMPC_MPC``), each with the JAX general runner's tracking
error at B=16 over 301 steps in its header, so the GPU smoke run can gate
on it without JAX.  ``--write-asset nonlinear`` leaves the other two
files as they are.

The corpus itself is committed too, for the port's trainer (which runs
without JAX): ``python tests/test_torch_oracle.py --write-corpus`` writes
the generator's f64 ``t``, ``y`` and ``u`` of every train and validation
trial to ``assets/arm3_corpus.npz`` (``x`` and ``w`` are left out: no
model reads them), read back by the port's ``utils/data.py:load_corpus``.

The paper's two sweeps have references of their own, written with
JAX's x64 session on the CPU: ``--write-lasso-refs`` trains
``LASSO_SWEEP``'s six lasso candidates, runs the JAX closed-loop lasso
sweep on them and writes each candidate's quality with f32 runs of
its loop (``assets/lasso_sweep_refs.json``) and the candidates
themselves (``assets/lasso_sweep_candidates.npz``); ``--write-rand-refs``
runs the JAX random-system sweep of ``RAND_MODELS``
(``assets/rand_models_refs.json``).  chip_smoke.py's phases LS and RS
read them.  The loaded experiment's data (phase LD) comes from
``--write-loaded`` (its corpus, the two JAX-trained loaded assets and
``assets/loaded_refs.json``); ``--write-loaded-refs`` reruns only the
JAX runs of the references on the committed loaded assets.
``--write-dictionary-full [PATH ...]`` reruns only the JAX runs on every
full-width lane of ``dictionary_refs.json`` (the model in the loop in x64
and f32, del1 in f32).  ``--write-angles`` generates the angle-output
corpus (``assets/arm3_angles_corpus.npz``), trains the bilinear and
linear poly-3 PCA f32 models on it with JAX
(``assets/arm3_angles_{bilinear,linear}_poly3.npz``) and writes
``assets/runner_refs.json``: the JAX x64 general runner on
``ArmConfig()``'s default plant and on the angle models
(``RUNNER_PATHS``), with the angle reference's rows.  ``--write-knob-refs``
writes ``assets/knob_refs.json``: the JAX x64 general runner in every
controller knob of ``KNOB_PATHS`` with its f32 runs (a 96-copy band where
the loop amplifies f32 rounding) and the lasso sweep at
``bilinear_iters=2`` (``KNOB_LASSO``).

The linear controller runs ``qp_iters=6`` with cold duals.  The JAX
package's "verified linear floor" of 3 iterations
(``ops/pallas/step_fused.py:201,244``, ``tests/test_step_fused.py:98``)
belongs to the MATLAB datafile's model: on this corpus's linear model
(NL=28, spectral radius 1.0000) the JAX general runner at B=16 over 301
blockM steps (x64, CPU) loses every lane between steps 59 and 62 at
``qp_iters=3`` and at 4 (alive 0.0), keeps them all from 5 on (err_mean
0.63318 at 5, 0.63300 at 6, 0.63317 at 8, 0.63318 at 12).  6 is one
iteration above the 16-lane edge, because iteration floors move with
batch size and precision.
"""

from __future__ import annotations

import functools
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)      # as tests/conftest.py
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from koopman_realizations_tpu.config import (  # noqa: E402
    ArmConfig,
    MpcConfig,
    SysidConfig,
)

ASSETS = ROOT / "koopman_realizations_torch" / "assets"
ASSET = ASSETS / "arm3_bilinear_poly3.npz"
LINEAR_ASSET = ASSETS / "arm3_linear_poly3.npz"
NONLINEAR_ASSET = ASSETS / "arm3_nonlinear_poly3.npz"
CORPUS_ASSET = ASSETS / "arm3_corpus.npz"

# the bench controller (bench.py:95-105 at its defaults)
BENCH_MPC = dict(
    horizon=10, qp_iters=4, qp_dual_warm=True, qp_dual_shift=False,
    input_blocks=(1, 1, 2, 5),
    input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8), input_slopeConst=1e-1,
    cost_running=10.0, cost_terminal=100.0,
    cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5))
# the linear controller: the bench's horizon, blocks, bounds and costs
# (tests/test_step_fused.py:97-102) at qp_iters=6, cold duals (see above)
LINEAR_MPC = dict(BENCH_MPC, qp_iters=6, qp_dual_warm=False)
# the SQP NMPC controller: the bench's horizon, blocks, bounds and costs
# with the JAX package's verified NMPC setting (scripts/perf_report.py:
# 137-148): qp_iters=8, cold duals, MpcConfig's default SQP regime
# (5 passes, damping 0.05, 'hold' first pass)
NMPC_MPC = dict(BENCH_MPC, qp_iters=8, qp_dual_warm=False)
# the SQP regimes that leave the multipass route, each on top of NMPC_MPC:
# the six single knobs and the line search with best-of-passes, and the
# 'linear' between-pass update alone and with best-of-passes, with the
# values the JAX package pins (tests/test_closed_loop.py:270-283).  The
# JAX general runner (x64, CPU, B=16 x 301 blockM steps) keeps every lane
# of the 'linear' update from qp_iters=4 on (0.875 alive at 3), with
# best-of-passes from 3 on; they run at NMPC_MPC's 8.
NMPC_REGIMES = {
    "dual_warm": dict(sqp_dual_warm=True),
    "damping_decay": dict(sqp_damping=0.3, sqp_damping_decay=0.5),
    "linesearch": dict(sqp_linesearch=2),
    "best_of_passes": dict(sqp_best_of_passes=True),
    "multistart": dict(sqp_multistart=True),
    "jac_period": dict(sqp_jac_period=2),
    "linesearch_best": dict(sqp_linesearch=2, sqp_best_of_passes=True),
    "linear_update": dict(sqp_update="linear"),
    "linear_update_best": dict(sqp_update="linear", sqp_best_of_passes=True),
}
REGIME_REFS = ASSETS / "nmpc_regime_refs.json"
# the bilinear controller off the lift-fused route, each on top of
# BENCH_MPC: iterated relinearization (pass 0 assembly-fused and blocked,
# pass 1 re-rolled), and the unblocked stack the MATLAB reference runs
# (Ksim.m:210), without and with smoothness rows (dense A^T D A).  On this
# corpus's model the JAX general runner (x64, CPU, B=16 x 301 blockM
# steps) keeps every lane of the unblocked stack from qp_iters=6 on
# (0.75 alive at 4), and of the smooth stack at 12 (all lanes lost from
# step 3 at 4, 0.8125 alive at 8 with smoothness 1.0); 8 is two above
# the 16-lane edge, because iteration floors move with batch size and
# precision.
BILINEAR_ROUTES = {
    "iters2": dict(bilinear_iters=2),
    "unblocked": dict(input_blocks=None, qp_iters=8),
    "unblocked_smooth": dict(input_blocks=None, input_smoothConst=0.1,
                             qp_iters=12),
}
BILINEAR_ROUTE_REFS = ASSETS / "bilinear_route_refs.json"
# the closed-loop lasso sweep (chip_smoke.py phase LS): the bilinear
# asset recipe trained at six lasso values with the trainer's default cap
# and tol, then the JAX sweep's controller and plant
# (tests/test_lasso_sweep.py:17-25: the unblocked horizon-10 stack at the
# default 12 iterations; the arm with SDIRK2, 5 substeps, 3 Newton
# iterations, jac_mode='substep') over 301 blockM steps
LASSO_SWEEP = dict(
    lasso=(2.0, 4.0, 8.0, 16.0, 32.0, float("inf")),
    lasso_iters=50000, lasso_tol=1e-12, steps=301,
    arm=dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
             substeps=5),
    mpc=dict(horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
             input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
             cost_input=(3e-3, 2e-3, 1e-3), proj_idx=(4, 5)))
LASSO_SWEEP_REFS = ASSETS / "lasso_sweep_refs.json"
LASSO_CANDIDATES = ASSETS / "lasso_sweep_candidates.npz"
# the f32 runs beside each candidate's reference: lanes a candidate (the
# model as trained, and copies with A moved by one ulp) and their seed
F32_COPIES, F32_SEED = 96, 0
# the random-system sweep at the reference's scale (chip_smoke.py phase
# RS): 20 systems, 10 training trials and 1 validation trial each
# (rsys-all_train-10_val-1), tests/test_rsys.py:92-96's recipe at those
# counts, then every degree of evaluate_rand_models' defaults (460 fits)
RAND_MODELS = dict(
    seed=0, num_sys=20, num_terms=5, degree_x=3, degree_u=1, t_end=25.0,
    Ts=0.05, num_trials=11, max_degree_linear=13, max_degree_bilinear=6,
    max_degree_nonlinear=4, nonlinear_lasso=4.0, lasso_iters=500)
RAND_MODELS_REFS = ASSETS / "rand_models_refs.json"
# the bench plant (bench.py:118-122)
BENCH_ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
                 substeps=3, newton_iters=1, jac_mode="step")
CORPUS = dict(trials=15, tf=60.0, n_val=5, seed=0)
REF_B, REF_STEPS = 16, 301
# the loaded-arm experiment (BASELINE.md row 5; the JAX package's
# scripts/perf_report.py:243-290 and tests/test_loaded.py:22-38): the
# 2-module arm with an unknown payload, its corpus (a ramp-and-hold
# excitation on a 16-load grid, seed 7), the loaded poly-2 models with
# PCA (lifted state [g; w1 g; w2 g]), the blocked controller at 10 cold
# iterations with the load observer (horizon 10, every 2 steps) on the
# circle reference; lanes: the first joint spread over +-0.15 rad, the
# loads of the round-4 floor grid cycled over the lanes
LOADED = dict(
    arm=dict(Nmods=2, nlinks=1, L=1.0, m=0.1, output_type="markers",
             substeps=5),
    corpus=dict(seed=7, tf=30.0, Tramp=2.0,
                loads=[[a, b] for a in (0.0, 0.33, 0.66, 1.0)
                       for b in (-1.0, -0.33, 0.33, 1.0)]),
    sysid=dict(obs_type=("poly",), obs_degree=(2,), loaded=True,
               dim_red=True, dtype="float32"),
    mpc=dict(horizon=10, input_bounds=(-7 * np.pi / 8, 7 * np.pi / 8),
             input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
             cost_input=(3e-3, 2e-3), proj_idx=(2, 3), load_obs_horizon=10,
             load_obs_period=2, input_blocks=(1, 1, 2, 5), qp_iters=10),
    grid=[[0.9, -0.6], [0.4, 0.2], [0.0, 0.0]], spread=0.15,
    B_ref=16, B_full=2048, steps=301)
LOADED_CORPUS = ASSETS / "arm2_loaded_corpus.npz"
LOADED_ASSETS = {"bilinear": ASSETS / "arm2_loaded_bilinear_poly2.npz",
                 "linear": ASSETS / "arm2_loaded_linear_poly2.npz"}
LOADED_REFS = ASSETS / "loaded_refs.json"
# the runs of the references: (controller model, observer on)
LOADED_RUNS = (("bilinear", True), ("bilinear", False), ("linear", True),
               ("linear", False))
# JAX f32 runs beside each loaded reference: the asset and one-ulp copies
# (as many as the lasso sweep's F32_COPIES: the loop with the observer
# amplifies f32 rounding lane by lane, and 6 copies left one lane of the
# card 1.46e-3 from x64 with the band's widest lane 1.44e-3 wide)
LOADED_F32_COPIES = 96


def blockM_y() -> np.ndarray:
    """The bench's blockM reference, (301, 2), built in-repo."""
    from koopman_realizations_tpu.utils.trajectories import (
        get_blockM,
        make_trajectory,
    )
    return make_trajectory(get_blockM([0.45, -0.35], 0.5, 0.5),
                           T=15, Ts=0.05)["y"]


def bench_X0(B: int) -> np.ndarray:
    """The bench's initial states: first joint spread over +-0.2 rad."""
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    return X0


def nmpc_lanes(B: int, seed: int):
    """NMPC test lanes, f64 lanes-minor: scaled outputs of random arm
    states (nz, B), random previous inputs inside the bounds (m, B) and
    the sqrt(Q)-scaled blockM reference windows of random steps (p, B),
    built by the port."""
    from koopman_realizations_torch.config import ArmConfig as TArm
    from koopman_realizations_torch.config import MpcConfig as TMpc
    from koopman_realizations_torch.control.kmpc import NonlinearKmpc
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.utils.checkpoint import load_model
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    model, scaler, _ = load_model(NONLINEAR_ASSET)
    mpc = NonlinearKmpc(model, scaler, TMpc(**NMPC_MPC), device="cpu",
                        dtype=torch.float64)
    arm = Arm(TArm(**BENCH_ARM), device="cpu")
    rng = np.random.default_rng(seed)
    X = np.zeros((6, B))
    X[:3] = rng.uniform(-0.4, 0.4, (3, B))
    X[3:] = rng.normal(0, 0.3, (3, B))
    zeta = scaler.y_down(arm.get_y(torch.from_numpy(X)), axis=0).double()
    up = torch.from_numpy(rng.uniform(-0.6, 0.6, (3, B)))
    wins = Ksim(arm, mpc, device="cpu").reference_windows(
        blockM_reference(), 300)
    sq = wins[torch.from_numpy(rng.integers(0, 299, B))].T.contiguous()
    return zeta, up, sq


def bilinear_lanes(port, B: int, seed: int):
    """Bilinear controller test lanes, f64 lanes-minor, for the port's
    controller ``port``: the lifted states of random arm states' scaled
    outputs (NL, B), previous inputs inside the bounds (m, B), a
    near-held previous plan (Np*m, B), positive multipliers in original
    units (mc, B), and the blockM reference windows of random steps --
    unscaled (B, Np+1, nproj) for JAX and sqrt(Q)-scaled (p, B) for the
    port."""
    from koopman_realizations_torch.config import ArmConfig as TArm
    from koopman_realizations_torch.models.arm import Arm
    rng = np.random.default_rng(seed)
    arm = Arm(TArm(**BENCH_ARM), device="cpu")
    X = np.zeros((6, B))
    X[:3] = rng.uniform(-0.4, 0.4, (3, B))
    X[3:] = rng.normal(0, 0.3, (3, B))
    zeta = port.scaler.y_down(arm.get_y(torch.from_numpy(X)), axis=0)
    up = torch.from_numpy(rng.uniform(-0.6, 0.6, (3, B)))
    U = up.repeat(port.Np, 1) + torch.from_numpy(
        rng.normal(0, 0.01, (port.Np * 3, B)))
    lam = torch.from_numpy(np.exp(rng.normal(-1.0, 1.0, (port.n_con, B))))
    ref = port.scaler.ref_down(blockM_y(), port.proj_idx)
    ks = rng.integers(0, ref.shape[0] - port.Np - 1, B)
    refhor = np.stack([ref[k:k + port.Np + 1] for k in ks])
    sqYr = torch.from_numpy(port.sqq[:, None] * refhor.reshape(B, -1).T)
    return port.lift(zeta.double()), up, U, lam, refhor, sqYr


@pytest.fixture
def one_thread():
    """The port's CPU tests run B <= 16 lanes, whose tensors are tiny: one
    thread runs them faster than the pool (measured ~2x on the closed
    loops); the count is restored afterwards.  Test modules use it with
    ``pytestmark = pytest.mark.usefixtures("one_thread")`` after importing
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lane_errors(Yp, ref_y, steps: int):
    """Per-lane mean tracking error, as bench.py:159-165."""
    Yl = np.asarray(Yp, np.float64)
    Rl = np.asarray(ref_y, np.float32)[None, : steps - 1].astype(np.float64)
    return np.sqrt(((Yl - Rl) ** 2).sum(-1)).mean(axis=1)


MODELS = {"bilinear": (ASSET, BENCH_MPC),
          "linear": (LINEAR_ASSET, LINEAR_MPC),
          "nonlinear": (NONLINEAR_ASSET, NMPC_MPC)}
# PCA threshold of each model's training (SysidConfig.pca_explained; the
# JAX default 99 for the condensed controllers)
PCA_EXPLAINED = {"bilinear": 99.0, "linear": 99.0, "nonlinear": 99.99}


@functools.lru_cache(maxsize=None)
def jax_model(kind: str = "bilinear"):
    """(model, scaler) of a committed asset, through the JAX loader."""
    from koopman_realizations_tpu.utils.checkpoint import load_model
    return load_model(str(MODELS[kind][0]))


@functools.lru_cache(maxsize=None)
def jax_bench(kind: str = "bilinear"):
    """(Ksim, controller, Arm) of the JAX package: the bench controller on
    the bilinear asset, the linear controller on the linear one, or the
    SQP NMPC controller on the nonlinear one (cached per process: the
    NMPC controller's first run compiles for tens of seconds)."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.models.arm import Arm
    model, scaler = jax_model(kind)
    mpc = make_kmpc(model, scaler, MpcConfig(**MODELS[kind][1]))
    arm = Arm(ArmConfig(**BENCH_ARM))
    return Ksim(arm, mpc), mpc, arm


@functools.lru_cache(maxsize=None)
def jax_nmpc(**knobs):
    """(Ksim, controller) of the JAX package: the SQP NMPC controller on
    the nonlinear asset with the SQP ``knobs`` (an entry of
    ``NMPC_REGIMES``, or any other) on top of ``NMPC_MPC``."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.models.arm import Arm
    model, scaler = jax_model("nonlinear")
    mpc = make_kmpc(model, scaler, MpcConfig(**NMPC_MPC, **knobs))
    return Ksim(Arm(ArmConfig(**BENCH_ARM)), mpc), mpc


@functools.lru_cache(maxsize=None)
def generate_corpus():
    from examples.generate_arm_data import generate
    return generate(CORPUS["trials"], CORPUS["tf"], n_val=CORPUS["n_val"],
                    seed=CORPUS["seed"])


def write_corpus(path: Path = CORPUS_ASSET) -> dict:
    """Write the generated corpus's f64 t, y, u of every trial to ``path``
    (see module doc); returns its header."""
    ds = generate_corpus()
    header = {
        "recipe": "examples/generate_arm_data.py:generate"
                  "(15, 60.0, n_val=5, seed=0), JAX x64 session on the CPU",
        "written_by": "python tests/test_torch_oracle.py --write-corpus",
        "fields": "t [T], y [T, n], u [T, m] of each trial, f64 (x and w "
                  "left out)",
        "split": {"train": len(ds.train), "val": len(ds.val)},
        "params": ds.params}
    arrays = {f"{split}{i}_{f}": np.asarray(getattr(tr, f), np.float64)
              for split in ("train", "val")
              for i, tr in enumerate(getattr(ds, split))
              for f in ("t", "y", "u")}
    np.savez(path, header=json.dumps(header), **arrays)
    return header


def train_jax(ds, kind: str = "bilinear"):
    from koopman_realizations_tpu.models.edmd import Ksysid
    return Ksysid(ds, SysidConfig(model_type=kind, obs_type=("poly",),
                                  obs_degree=(3,), dim_red=True,
                                  pca_explained=PCA_EXPLAINED[kind],
                                  dtype="float32")).train_models()


def one_step_predictions(model, valdata) -> np.ndarray:
    """Scaled one-step output predictions C (A z + B u) (linear) or
    C (A z + Beta(z) u) (bilinear) over every validation step -- invariant
    to PCA component signs."""
    out = []
    for tr in valdata:
        zeta = np.asarray(tr.y, np.float64)[:-1]
        u = np.asarray(tr.u, np.float64)[:-1]
        z = np.asarray(jax.vmap(model.basis.lift)(zeta), np.float64)
        A = np.asarray(model.A, np.float64)
        Bm = np.asarray(model.B, np.float64)
        C = np.asarray(model.C, np.float64)
        if Bm.ndim == 2:
            z1 = z @ A.T + u @ Bm.T
        else:
            z1 = z @ A.T + np.einsum("kmj,tj,tm->tk", Bm, z, u)
        out.append(z1 @ C.T)
    return np.concatenate(out)


@functools.lru_cache(maxsize=None)
def jax_general_run(B: int, steps: int, kind: str = "bilinear"):
    """The JAX general runner on one asset: (Yp, alive) as numpy."""
    sim, _, _ = jax_bench(kind)
    run = sim.batched_runner(blockM_y(), steps=steps, record=("Yp", "alive"))
    out = jax.block_until_ready(
        run(bench_X0(B), np.zeros((B, 2), np.float32)))
    return np.asarray(out["Yp"]), np.asarray(out["alive"])


def write_assets(kinds=tuple(MODELS)) -> dict:
    """Train on the generated corpus and write the assets of ``kinds``
    (see module doc); returns their headers."""
    from koopman_realizations_tpu.utils.checkpoint import save_model
    ds = generate_corpus()
    headers = {}
    for kind in kinds:
        path, mpc_cfg = MODELS[kind]
        ks = train_jax(ds, kind)
        path.parent.mkdir(parents=True, exist_ok=True)
        save_model(str(path), ks.model, ks.scaler, overwrite=True)
        jax_model.cache_clear()
        jax_bench.cache_clear()
        jax_general_run.cache_clear()
        Yp, alive = jax_general_run(REF_B, REF_STEPS, kind)
        err = lane_errors(Yp, blockM_y(), REF_STEPS)
        data = dict(np.load(path, allow_pickle=False))
        header = json.loads(str(data.pop("header")))
        header["provenance"] = {
            "corpus": "examples/generate_arm_data.py:generate"
                      "(15, 60.0, n_val=5, seed=0)",
            "sysid": f"Ksysid {kind} poly-3 dim_red=True "
                     + ("pca_explained=99.99 " if kind == "nonlinear"
                        else "")
                     + "dtype=float32",
            "written_by": "python tests/test_torch_oracle.py --write-asset"
                          + (" nonlinear" if kind == "nonlinear" else ""),
        }
        header["jax_reference"] = {
            "runner": "Ksim.batched_runner (x64 session, CPU)",
            "controller": f"qp_iters={mpc_cfg['qp_iters']} "
                          f"qp_dual_warm={mpc_cfg['qp_dual_warm']}"
                          + (f" sqp_iters={MpcConfig().sqp_iters}"
                             if kind == "nonlinear" else ""),
            "B": REF_B, "steps": REF_STEPS,
            "alive": float(alive[:, -1].mean()),
            "err_mean": float(err.mean()), "err_worst": float(err.max()),
        }
        np.savez(path, header=json.dumps(header), **data)
        headers[path.name] = header
    return headers


@functools.lru_cache(maxsize=None)
def jax_bilinear(**knobs):
    """(Ksim, controller) of the JAX package: the bilinear controller on
    the bilinear asset with ``knobs`` (an entry of ``BILINEAR_ROUTES``, or
    any other) on top of ``BENCH_MPC``."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.models.arm import Arm
    model, scaler = jax_model("bilinear")
    mpc = make_kmpc(model, scaler, MpcConfig(**{**BENCH_MPC, **knobs}))
    return Ksim(Arm(ArmConfig(**BENCH_ARM)), mpc), mpc


def _write_refs(configs: dict, sim_of, asset: str, path: Path,
                flag: str) -> dict:
    """Run the JAX general runner (x64, CPU, B=16 over 301 blockM steps,
    the bench's initial states) in each configuration and write err_mean,
    err_worst, alive and the full controller configuration of each to
    ``path`` under "regimes"; the model assets are not touched."""
    import dataclasses
    regimes = {}
    for name, knobs in configs.items():
        sim, mpc = sim_of(**knobs)
        run = sim.batched_runner(blockM_y(), steps=REF_STEPS,
                                 record=("Yp", "alive"))
        out = jax.block_until_ready(
            run(bench_X0(REF_B), np.zeros((REF_B, 2), np.float32)))
        err = lane_errors(np.asarray(out["Yp"]), blockM_y(), REF_STEPS)
        regimes[name] = {
            "knobs": knobs,
            "config": dataclasses.asdict(mpc.cfg),
            "alive": float(np.asarray(out["alive"])[:, -1].mean()),
            "err_mean": float(err.mean()), "err_worst": float(err.max())}
        print(name, regimes[name]["alive"], regimes[name]["err_mean"],
              flush=True)
    refs = {
        "runner": "koopman_realizations_tpu Ksim.batched_runner "
                  f"(jax_enable_x64, CPU) on assets/{asset}",
        "written_by": f"python tests/test_torch_oracle.py {flag}",
        "B": REF_B, "steps": REF_STEPS,
        "X0": "first joint spread over +-0.2 rad (bench_X0)",
        "reference": "blockM([0.45, -0.35], 0.5, 0.5), T=15, Ts=0.05",
        "regimes": regimes}
    path.write_text(json.dumps(refs, indent=1) + "\n")
    return refs


def write_regime_refs() -> dict:
    """The JAX quality of each SQP regime of ``NMPC_REGIMES`` on the
    nonlinear asset, in ``REGIME_REFS``."""
    return _write_refs(NMPC_REGIMES, jax_nmpc, NONLINEAR_ASSET.name,
                       REGIME_REFS, "--write-regime-refs")


def write_bilinear_refs() -> dict:
    """The JAX quality of each configuration of ``BILINEAR_ROUTES`` on the
    bilinear asset, in ``BILINEAR_ROUTE_REFS``."""
    return _write_refs(BILINEAR_ROUTES, jax_bilinear, ASSET.name,
                       BILINEAR_ROUTE_REFS, "--write-bilinear-refs")


def port_lasso_candidates():
    """([BilinearModel] of the port, Scaler) of ``LASSO_CANDIDATES``, in
    their own (the JAX training's) basis."""
    from koopman_realizations_torch.models.koopman import from_jax_arrays
    data = np.load(LASSO_CANDIDATES)
    header = json.loads(str(data["header"]))
    shared = {k: data[k] for k in data.files
              if k != "header" and not k.startswith(("A_", "B_"))}
    pairs = [from_jax_arrays(dict(header, lasso=lv),
                             dict(shared, A=data[f"A_{i}"], B=data[f"B_{i}"]))
             for i, lv in enumerate(header["lasso"])]
    return [m for m, _ in pairs], pairs[0][1]


def _port_sweep_f64() -> dict:
    """The port's plain lasso sweep (CPU, f64) of ``LASSO_CANDIDATES``:
    {"alive": [...], "err_mean": [...]} per candidate."""
    import types

    from koopman_realizations_torch.config import ArmConfig as TArmConfig
    from koopman_realizations_torch.config import MpcConfig as TMpcConfig
    from koopman_realizations_torch.models.arm import Arm as TArm
    from koopman_realizations_torch.workflows.lasso_sweep import (
        lasso_sweep_closed_loop as tsweep,
    )
    cands, scaler = port_lasso_candidates()
    r = LASSO_SWEEP
    o = tsweep(types.SimpleNamespace(candidates=cands, scaler=scaler),
               TArm(TArmConfig(**r["arm"]), device="cpu"),
               TMpcConfig(**r["mpc"]), blockM_y(), steps=r["steps"],
               device="cpu", dtype=torch.float64)
    return {"alive": [bool(a) for a in o["alive"][:, -1]],
            "err_mean": [float(e) for e in o["err"].mean(1)]}


def write_lasso_refs(path: Path = LASSO_SWEEP_REFS,
                     models: Path = LASSO_CANDIDATES) -> dict:
    """Train the bilinear asset recipe at ``LASSO_SWEEP``'s lasso values
    with the JAX ``Ksysid`` (x64, CPU) on the generated corpus and write
    the candidates (A, B of each; C, pcs and the scaler once) to
    ``models``; run the JAX ``lasso_sweep_closed_loop`` on them and write
    each candidate's err_mean, err_worst and alive at the last step to
    ``path``.

    Beside them go f32 runs of each candidate's loop, all of the JAX
    sweep with x64 off (``_jax_sweep_f32``): the candidate as trained and
    ``F32_COPIES - 1`` copies of it whose A is moved by one ulp (f32) in
    every nonzero entry, each in a direction drawn from ``F32_SEED``, all
    lanes of one batch.  A candidate is ``f32_stable`` when every such run
    keeps its alive flag and lands within gate 2's 1e-3 of the x64
    err_mean; else its loop amplifies f32 rounding, and ``f32_band``
    (the least and largest err_mean of those runs and the x64 one) is
    where chip_smoke.py's f32 card loop is held.  The port's f64 sweep of
    the same models must match the x64 one (alive, err_mean within 1e-5)
    first.
    """
    import dataclasses

    from koopman_realizations_tpu.models.arm import Arm
    from koopman_realizations_tpu.models.edmd import Ksysid
    from koopman_realizations_tpu.workflows.lasso_sweep import (
        lasso_sweep_closed_loop,
    )
    r = LASSO_SWEEP
    ks = Ksysid(generate_corpus(), SysidConfig(
        model_type="bilinear", pca_explained=PCA_EXPLAINED["bilinear"],
        obs_type=("poly",), obs_degree=(3,), dim_red=True, dtype="float32",
        lasso=r["lasso"], lasso_iters=r["lasso_iters"],
        lasso_tol=r["lasso_tol"])).train_models()
    written_by = "python tests/test_torch_oracle.py --write-lasso-refs"
    m0 = ks.candidates[0]
    header = {"meta": dataclasses.asdict(m0.meta),
              "basis": {"model_type": m0.basis.model_type,
                        "n": m0.basis.n, "m": m0.basis.m,
                        "nd": m0.basis.nd, "nw": m0.basis.nw,
                        "families": [list(f) for f in m0.basis.families]},
              "lasso": [float(cd.lasso) for cd in ks.candidates],
              "written_by": written_by,
              "fields": "A_i, B_i of candidate i (f32, the JAX trainer's); "
                        "C, pcs and scaler_<field> shared"}
    arrays = {f"{k}_{i}": np.asarray(getattr(cd, k))
              for i, cd in enumerate(ks.candidates) for k in ("A", "B")}
    arrays.update(C=np.asarray(m0.C), pcs=np.asarray(m0.basis.pcs),
                  **{"scaler_" + f: np.asarray(getattr(ks.scaler, f))
                     for f in ("y_factor", "y_offset", "u_factor",
                               "u_offset")})
    np.savez_compressed(models, header=json.dumps(header), **arrays)

    mpc = MpcConfig(**r["mpc"])
    out = lasso_sweep_closed_loop(ks, Arm(ArmConfig(**r["arm"])), mpc,
                                  blockM_y(), steps=r["steps"])
    err, alive = np.asarray(out["err"]), np.asarray(out["alive"])
    port64 = _port_sweep_f64()
    for i in range(len(ks.candidates)):
        if port64["alive"][i] != bool(alive[i, -1]) \
                or abs(port64["err_mean"][i] - err[i].mean()) > 1e-5:
            raise AssertionError(f"the port's f64 sweep parts from JAX's "
                                 f"(candidate {i})")
    jax32 = _jax_sweep_f32(ks, F32_COPIES, F32_SEED)
    cands = {}
    for i, (lv, cd) in enumerate(zip(out["lasso"], ks.candidates)):
        K = np.asarray(cd.K, np.float64)
        em, al = float(err[i].mean()), bool(alive[i, -1])
        f32 = jax32[i * F32_COPIES:(i + 1) * F32_COPIES]
        ems = [e for _, e in f32] + [em]
        cands[str(lv)] = {
            "lasso": lv, "alive": al, "err_mean": em,
            "err_worst": float(err[i].max()),
            "port_f64_err_mean": port64["err_mean"][i],
            "f32_runs": f32,
            "f32_stable": all(a == al and abs(e - em) < 1e-3
                              for a, e in f32),
            "f32_band": [min(ems), max(ems)],
            "l1": float(np.abs(K).sum()), "budget": lv * ks.N}
        print(lv, cands[str(lv)], flush=True)
    refs = {
        "runner": "koopman_realizations_tpu Ksysid + workflows/lasso_sweep."
                  "lasso_sweep_closed_loop (jax_enable_x64, CPU); f32 runs "
                  "of the JAX sweep (x64 off) on the same models, "
                  f"{F32_COPIES} lanes a candidate: as trained and with A "
                  f"moved by one ulp (seed {F32_SEED})",
        "written_by": written_by,
        "recipe": {**{k: list(v) if isinstance(v, tuple) else v
                      for k, v in r.items() if k not in ("arm", "mpc")},
                   "arm": r["arm"],
                   "mpc": {k: list(v) if isinstance(v, tuple) else v
                           for k, v in r["mpc"].items()},
                   "training": "bilinear poly-3, PCA at 99 %, f32 lift, "
                               "on generate(15, 60.0, n_val=5, seed=0)",
                   "config": dataclasses.asdict(mpc)},
        "reference": "blockM([0.45, -0.35], 0.5, 0.5), T=15, Ts=0.05",
        "models": models.name, "NL": ks.N, "candidates": cands}
    path.write_text(json.dumps(refs, indent=1) + "\n")
    return refs


def _jax_sweep_f32(ks, copies: int, seed: int, mpc: dict = None) -> list:
    """The JAX lasso sweep of ``ks``'s candidates with x64 off (f32
    throughout) in a process of its own, ``copies`` lanes a candidate in
    one batch (candidate-major): the first as trained, each other with
    every nonzero entry of its f32 A moved one ulp up or down, the
    directions drawn from ``np.random.default_rng(seed)``; ``mpc``
    overrides fields of ``LASSO_SWEEP``'s controller.  Returns [alive at
    the last step, err_mean] per lane."""
    import subprocess
    import tempfile

    from koopman_realizations_tpu.utils.checkpoint import save_model
    with tempfile.TemporaryDirectory() as d:
        paths = [save_model(f"{d}/c{i}", cd, ks.scaler)
                 for i, cd in enumerate(ks.candidates)]
        code = (
            "import dataclasses, json, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "jax.config.update('jax_enable_x64', False)\n"
            "import numpy as np\n"
            "from types import SimpleNamespace\n"
            "from koopman_realizations_tpu.config import ArmConfig, "
            "MpcConfig\n"
            "from koopman_realizations_tpu.models.arm import Arm\n"
            "from koopman_realizations_tpu.utils.checkpoint import "
            "load_model\n"
            "from koopman_realizations_tpu.utils.trajectories import "
            "get_blockM, make_trajectory\n"
            "from koopman_realizations_tpu.workflows.lasso_sweep import "
            "lasso_sweep_closed_loop\n"
            f"r = json.loads({json.dumps(json.dumps(LASSO_SWEEP))})\n"
            f"r['mpc'].update(json.loads({json.dumps(json.dumps(mpc or {}))}))\n"
            f"ms = [load_model(p) for p in {paths!r}]\n"
            f"rng = np.random.default_rng({seed})\n"
            "lanes = []\n"
            "for m, _ in ms:\n"
            "    A = np.asarray(m.A, np.float32)\n"
            f"    for k in range({copies}):\n"
            "        up = rng.random(A.shape) < 0.5 if k else None\n"
            "        Ak = A if k == 0 else np.where(A == 0, A, np.nextafter("
            "A, np.where(up, np.inf, -np.inf).astype(np.float32)))\n"
            "        lanes.append(dataclasses.replace(m, A=Ak))\n"
            "ref = make_trajectory(get_blockM([0.45, -0.35], 0.5, 0.5), "
            "T=15, Ts=0.05)['y']\n"
            "mpc = MpcConfig(**{k: tuple(v) if isinstance(v, list) else v "
            "for k, v in r['mpc'].items()})\n"
            "ks = SimpleNamespace(candidates=lanes, scaler=ms[0][1], "
            "basis=ms[0][0].basis)\n"
            "out = lasso_sweep_closed_loop(ks, Arm(ArmConfig(**r['arm'])), "
            "mpc, ref, steps=r['steps'])\n"
            "assert np.asarray(out['err']).dtype == np.float32\n"
            "print(json.dumps([[bool(a), float(e)] for a, e in zip("
            "np.asarray(out['alive'])[:, -1], "
            "np.asarray(out['err']).mean(1))]))\n")
        run = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True,
                             env=dict(os.environ, JAX_ENABLE_X64="0"))
    return json.loads(run.stdout.strip().splitlines()[-1])


def write_rand_refs(path: Path = RAND_MODELS_REFS) -> dict:
    """Draw and simulate ``RAND_MODELS``'s ensemble with the JAX
    ``models/rsys.py`` (x64, CPU), run the JAX ``evaluate_rand_models`` on
    it and write each family's medians, kept count, kept mask and errors
    to ``path``."""
    from koopman_realizations_tpu.models.rsys import (
        construct_systems,
        simulate_systems,
    )
    from koopman_realizations_tpu.workflows import evaluate_rand_models
    r = RAND_MODELS
    rng = np.random.default_rng(r["seed"])
    ens = construct_systems(r["num_sys"], r["num_terms"], r["degree_x"],
                            r["degree_u"], rng)
    ds = simulate_systems(ens, r["t_end"], r["Ts"], r["num_trials"], rng)
    out = evaluate_rand_models(
        ds, max_degree_linear=r["max_degree_linear"],
        max_degree_bilinear=r["max_degree_bilinear"],
        max_degree_nonlinear=r["max_degree_nonlinear"],
        nonlinear_lasso=r["nonlinear_lasso"], lasso_iters=r["lasso_iters"])
    fams = {}
    for fam, o in out.items():
        err = np.asarray(o["err"])
        keep = np.all(np.isfinite(err), 0) & np.all(err < 10, 0)
        fams[fam] = {"median": [float(v) for v in o["median"]],
                     "kept": int(o["kept"]), "keep": keep.tolist(),
                     "dims": [int(v) for v in o["dims"]],
                     "err": [[float(v) for v in row] for row in err]}
        print(fam, fams[fam]["kept"], fams[fam]["median"], flush=True)
    refs = {
        "runner": "koopman_realizations_tpu models/rsys.py + workflows/"
                  "rand_models.evaluate_rand_models (jax_enable_x64, CPU)",
        "written_by": "python tests/test_torch_oracle.py --write-rand-refs",
        "recipe": dict(r), "families": fams}
    path.write_text(json.dumps(refs, indent=1) + "\n")
    return refs


def loaded_lanes(B: int):
    """The loaded experiment's lanes (X0 (B, 4), W (B, 2)), f64: the
    first ``B_ref`` lanes (all of them for B <= B_ref) take the first
    joint from linspace(-spread, spread, B_ref), the rest from
    linspace(-spread, spread, B - B_ref); lane i carries the load
    grid[i % 3]."""
    r = LOADED
    X0 = np.zeros((B, 4))
    nref = min(B, r["B_ref"])
    X0[:nref, 0] = np.linspace(-r["spread"], r["spread"], r["B_ref"])[:nref]
    if B > nref:
        X0[nref:, 0] = np.linspace(-r["spread"], r["spread"], B - nref)
    W = np.asarray(r["grid"], np.float64)[np.arange(B) % len(r["grid"])]
    return X0, W


def circle_y() -> np.ndarray:
    """The loaded experiment's circle reference, (301, 2), built in-repo
    (tests/test_loaded.py:85-87)."""
    from koopman_realizations_tpu.utils.trajectories import (
        get_circle,
        make_trajectory,
    )
    return make_trajectory(get_circle([0.0, -0.7], 0.3), T=15.0, Ts=0.05,
                           flip_y=True, preamble_from=(0.0, 1.0))["y"]


@functools.lru_cache(maxsize=None)
def generate_loaded_corpus():
    """The loaded corpus of tests/test_loaded.py:22-38 (JAX arm,
    ``simulate_rampNhold_batch``): 15 training trials and the last one
    for validation."""
    from koopman_realizations_tpu.models.arm import Arm
    from koopman_realizations_tpu.types import DataSet, Trial
    c = LOADED["corpus"]
    arm = Arm(ArmConfig(**LOADED["arm"]))
    sims = arm.simulate_rampNhold_batch(
        np.random.default_rng(c["seed"]), tf=c["tf"], Tramp=c["Tramp"],
        W=np.asarray(c["loads"]))
    trials = [Trial(t=s["t"], y=s["y"], u=s["u"], x=s["x"], w=s["w"])
              for s in sims]
    return DataSet(train=trials[:-1], val=trials[-1:],
                   params={"sysName": "loaded"})


def train_jax_loaded(ds, kind: str):
    from koopman_realizations_tpu.models.edmd import Ksysid
    return Ksysid(ds, SysidConfig(model_type=kind, **LOADED["sysid"])
                  ).train_models()


@functools.lru_cache(maxsize=None)
def jax_loaded_model(kind: str):
    """(model, scaler) of a committed loaded asset, through the JAX
    loader."""
    from koopman_realizations_tpu.utils.checkpoint import load_model
    return load_model(str(LOADED_ASSETS[kind]))


def jax_loaded_sim(kind: str, observer: bool, model=None, scaler=None,
                   **knobs):
    """The JAX ``Ksim`` of the loaded experiment: the controller of
    ``LOADED["mpc"]`` (with ``knobs`` on top) on the loaded asset of
    ``kind`` (or ``model``), the load observer when ``observer``."""
    from koopman_realizations_tpu.control import (
        Ksim,
        make_kmpc,
        make_load_observer,
    )
    from koopman_realizations_tpu.models.arm import Arm
    if model is None:
        model, scaler = jax_loaded_model(kind)
    cfg = MpcConfig(**{**LOADED["mpc"], **knobs})
    obs = make_load_observer(model, cfg) if observer else None
    return Ksim(Arm(ArmConfig(**LOADED["arm"])), make_kmpc(model, scaler,
                                                           cfg),
                observer=obs)


def jax_loaded_run(sim, X0, W, steps: int) -> dict:
    """The JAX general runner (``Ksim.batched_runner``, the semantics of
    ``run_batch``) on the circle: per-lane {err (B, steps-1) as
    ``run_batch`` computes it, alive (B, steps-1), What (B, steps-1,
    nw)} as numpy."""
    run = sim.batched_runner(circle_y(), steps=steps,
                             record=("Y", "R", "alive", "what"))
    out = jax.block_until_ready(run(jax.numpy.asarray(X0),
                                    jax.numpy.asarray(W)))
    Y, R = np.asarray(out["Y"]), np.asarray(out["R"])
    err = np.sqrt(((R - Y[..., list(sim.mpc.proj_idx)]) ** 2).sum(-1))
    return {"err": err, "alive": np.asarray(out["alive"]),
            "What": np.asarray(out["what"])}


def _jax_loaded_f32(B: int, runs, copies: int = 1, seed: int = 0) -> dict:
    """The JAX general runner of the loaded experiment with x64 off (f32
    throughout) on ``loaded_lanes(B)``, for each (kind, observer) of
    ``runs`` in a process of its own (all started together) and each of
    ``copies`` models: the asset as trained and, after it, copies with
    every nonzero entry of its f32 A moved one ulp up or down (directions
    from ``np.random.default_rng(seed)``, drawn anew for each run).
    Returns {"kind/obs": [[[alive, err_mean] per lane] per copy]}."""
    import subprocess
    code = (
        "import dataclasses, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np\n"
        "import test_torch_oracle as O\n"
        "jax.config.update('jax_enable_x64', False)\n"
        f"X0, W = O.loaded_lanes({B})\n"
        "X0, W = X0.astype(np.float32), W.astype(np.float32)\n"
        f"rng = np.random.default_rng({seed})\n"
        "kind, obs = sys.argv[1], sys.argv[2] == 'True'\n"
        "model, scaler = O.jax_loaded_model(kind)\n"
        "A = np.asarray(model.A, np.float32)\n"
        "lanes = []\n"
        f"for k in range({copies}):\n"
        "    up = rng.random(A.shape) < 0.5\n"
        "    Ak = A if k == 0 else np.where(A == 0, A, np.nextafter("
        "A, np.where(up, np.inf, -np.inf).astype(np.float32)))\n"
        "    sim = O.jax_loaded_sim(kind, obs, dataclasses.replace("
        "model, A=Ak), scaler)\n"
        "    r = O.jax_loaded_run(sim, X0, W, O.LOADED['steps'])\n"
        "    assert r['err'].dtype == np.float32\n"
        "    lanes.append([[bool(a), float(e)] for a, e in zip("
        "r['alive'][:, -1], r['err'].mean(1))])\n"
        "print(json.dumps(lanes))\n")
    procs = {f"{kind}/{obs}": subprocess.Popen(
        [sys.executable, "-c", code, kind, str(obs)], stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, JAX_ENABLE_X64="0"))
        for kind, obs in runs}
    out = {}
    for key, proc in procs.items():
        stdout, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the JAX f32 run of {key} failed")
        out[key] = json.loads(stdout.strip().splitlines()[-1])
    return out


def write_loaded() -> dict:
    """Write the loaded experiment's data (see module doc): the corpus,
    the two JAX-trained loaded assets and ``LOADED_REFS``."""
    from koopman_realizations_tpu.utils.checkpoint import save_model
    r = LOADED
    written_by = "python tests/test_torch_oracle.py --write-loaded"
    recipe = (f"tests/test_loaded.py:22-38: Arm({r['arm']}) "
              f"simulate_rampNhold_batch(default_rng({r['corpus']['seed']}),"
              f" tf={r['corpus']['tf']}, Tramp={r['corpus']['Tramp']}, "
              f"W=16-load grid), trials[:-1] train, trials[-1:] val; JAX "
              f"x64 session on the CPU")
    ds = generate_loaded_corpus()
    header = {"recipe": recipe, "written_by": written_by,
              "fields": "t [T], y [T, n], u [T, m], w [T, nw] of each "
                        "trial, f64 (x left out)",
              "split": {"train": len(ds.train), "val": len(ds.val)},
              "params": ds.params}
    arrays = {f"{split}{i}_{f}": np.asarray(getattr(tr, f), np.float64)
              for split in ("train", "val")
              for i, tr in enumerate(getattr(ds, split))
              for f in ("t", "y", "u", "w")}
    np.savez(LOADED_CORPUS, header=json.dumps(header), **arrays)
    out = {LOADED_CORPUS.name: header}
    for kind, path in LOADED_ASSETS.items():
        ks = train_jax_loaded(ds, kind)
        save_model(str(path), ks.model, ks.scaler, overwrite=True)
        data = dict(np.load(path, allow_pickle=False))
        h = json.loads(str(data.pop("header")))
        h["provenance"] = {
            "corpus": recipe,
            "sysid": f"Ksysid {kind} poly-2 loaded=True dim_red=True "
                     f"dtype=float32",
            "written_by": written_by}
        np.savez(path, header=json.dumps(h), **data)
        out[path.name] = h
    jax_loaded_model.cache_clear()
    out[LOADED_REFS.name] = write_loaded_refs()
    return out


def write_loaded_refs(copies: int = LOADED_F32_COPIES) -> dict:
    """Run the JAX general runner on the committed loaded assets and write
    ``LOADED_REFS``: per run of ``LOADED_RUNS`` and reference lane (x64)
    alive, err_mean and the last What; JAX's own f32 runs of the same
    lanes (the asset and ``copies`` - 1 one-ulp copies of its A: each
    lane's band); JAX's f32 run of the bilinear controller with the
    observer at B_full.  Returns the file's header."""
    r = LOADED
    X0, W = loaded_lanes(r["B_ref"])
    runs = {}
    for kind, obs in LOADED_RUNS:
        res = jax_loaded_run(jax_loaded_sim(kind, obs), X0, W, r["steps"])
        runs[f"{kind}/{obs}"] = {
            "alive": [bool(a) for a in res["alive"][:, -1]],
            "err_mean": [float(e) for e in res["err"].mean(1)],
            "What_last": [[float(v) for v in w] for w in res["What"][:, -1]],
            "What_absmax": float(np.abs(res["What"]).max())}
        print(kind, obs, np.mean(runs[f"{kind}/{obs}"]["err_mean"]),
              flush=True)
    f32_ref = _jax_loaded_f32(r["B_ref"], LOADED_RUNS, copies)
    f32_full = _jax_loaded_f32(r["B_full"], LOADED_RUNS[:1])
    for key, per_copy in f32_ref.items():
        e = np.asarray([[v for _, v in lanes] for lanes in per_copy])
        runs[key]["f32"] = {
            "alive": [a for a, _ in per_copy[0]],
            "err_mean": [float(v) for v in e[0]],
            "all_alive": bool(all(a for lanes in per_copy
                                  for a, _ in lanes)),
            "band": [[float(lo), float(hi)]
                     for lo, hi in zip(e.min(0), e.max(0))],
            "band_mean": [float(e.mean(1).min()), float(e.mean(1).max())]}
        print(key, "f32 band width", float((e.max(0) - e.min(0)).max()),
              flush=True)
    full = f32_full["bilinear/True"][0]
    refs = {
        "runner": "koopman_realizations_tpu Ksim.batched_runner (the "
                  "semantics of run_batch; jax_enable_x64, CPU) on the "
                  "loaded assets",
        "written_by": "python tests/test_torch_oracle.py --write-loaded-refs"
                      " (or --write-loaded)",
        "recipe": {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in r.items() if k not in ("mpc", "sysid")},
        "mpc": {k: list(v) if isinstance(v, tuple) else v
                for k, v in r["mpc"].items()},
        "sysid": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in r["sysid"].items()},
        "reference": "make_trajectory(get_circle([0, -0.7], 0.3), T=15, "
                     "Ts=0.05, flip_y=True, preamble_from=(0, 1))",
        "lanes": "loaded_lanes(B): the first 16 lanes X0[:, 0] = "
                 "linspace(-0.15, 0.15, 16), the rest linspace(-0.15, "
                 "0.15, B - 16); load grid[i % 3]",
        "f32": f"JAX with x64 off on the same lanes: the asset and "
               f"{copies - 1} copies with every nonzero of A moved one ulp "
               f"(seed 0); band = each lane's [min, max] err_mean, "
               f"band_mean = the [min, max] of the copies' err_mean over "
               f"the lanes",
        "steps": r["steps"], "runs": runs,
        "f32_full": {"B": r["B_full"], "run": "bilinear/True",
                     "alive": float(np.mean([a for a, _ in full])),
                     "err_mean": float(np.mean([e for _, e in full]))}}
    LOADED_REFS.write_text(json.dumps(refs, indent=1) + "\n")
    return {k: v for k, v in refs.items() if k != "runs"}


# ------------------------------------------------------- dictionaries

# every dictionary the JAX trainer builds, each trained by the JAX package
# on the committed corpus (assets/arm3_corpus.npz) with an f32 lift and
# written by ``--write-dictionaries``: the paper's headline delayed
# bilinear model (BASELINE.json #2: poly-2, delays=1, PCA 99 %), the
# paper's basis size without PCA (poly-3, N = 84), the snake's dictionary
# (fourier_sparser 1, BASELINE.json #5, on the arm corpus: the snake's
# datafile is absent), a mixed poly + gaussian linear model and a
# fourier_sparser nonlinear model
DICT_ASSETS = {
    "del1": ("arm3_bilinear_poly2_del1.npz",
             dict(model_type="bilinear", obs_type=("poly",),
                  obs_degree=(2,), delays=1, dim_red=True)),
    "nopca": ("arm3_bilinear_poly3_nopca.npz",
              dict(model_type="bilinear", obs_type=("poly",),
                   obs_degree=(3,))),
    "fs1": ("arm3_bilinear_fsparse1.npz",
            dict(model_type="bilinear", obs_type=("fourier_sparser",),
                 obs_degree=(1,))),
    "mix": ("arm3_linear_polygauss.npz",
            dict(model_type="linear", obs_type=("poly", "gaussian"),
                 obs_degree=(2, 20))),
    "nmpc-fs1": ("arm3_nonlinear_fsparse1.npz",
                 dict(model_type="nonlinear",
                      obs_type=("fourier_sparser",), obs_degree=(1,))),
}
# the trainings phase DX1 also runs on the card (no asset): a linear
# hermite-2 model (N_full 34), a linear full-fourier-1 model (N_full 735)
# and two continuous-time ones
DICT_TRAININGS = {
    "hermite2": dict(model_type="linear", obs_type=("hermite",),
                     obs_degree=(2,)),
    "fourier1": dict(model_type="linear", obs_type=("fourier",),
                     obs_degree=(1,)),
    "cont-linear": dict(model_type="linear", obs_type=("poly",),
                        obs_degree=(1,), time_type="continuous"),
    "cont-bilinear": dict(model_type="bilinear", obs_type=("poly",),
                          obs_degree=(2,), time_type="continuous"),
}
# the closed loops of phase DX: (asset, plant, the controller's knobs on
# top of its base configuration); every one on the bench's blockM
# reference, the arm ``BENCH_ARM`` or the model itself ("model", lanes
# from lifted 0.15 randn zetas, scripts/perf_report.py:230-233); each
# qp_iters is the smallest count from ``DICT_QP_FROM`` at which the JAX
# x64 general runner keeps all 16 reference lanes alive (written beside
# the configuration into ``DICT_REFS``)
DICT_PATHS = {
    "del1": ("del1", "arm", dict(BENCH_MPC)),
    "nopca": ("nopca", "arm", dict(BENCH_MPC)),
    "fs1": ("fs1", "arm", dict(BENCH_MPC)),
    "fs1-unblocked": ("fs1", "arm", dict(BENCH_MPC, input_blocks=None,
                                         qp_dual_warm=False)),
    "fs1-model": ("fs1", "model", dict(BENCH_MPC)),
    "mix": ("mix", "arm", dict(LINEAR_MPC)),
    "nmpc-fs1": ("nmpc-fs1", "arm", dict(NMPC_MPC)),
    "nmpc-bilin": ("bilinear", "arm", dict(NMPC_MPC, mpc_type="nonlinear")),
}
DICT_QP_FROM, DICT_QP_TO = 3, 16
DICT_REFS = ASSETS / "dictionary_refs.json"
DICT_F32_COPIES = 96


def dict_asset_path(name: str) -> Path:
    return ASSET if name == "bilinear" else ASSETS / DICT_ASSETS[name][0]


def dict_sysid(name: str) -> dict:
    """A dictionary recipe's SysidConfig keywords (f32 lift, PCA at the
    default 99 % where the recipe asks for it)."""
    recipe = DICT_ASSETS[name][1] if name in DICT_ASSETS \
        else DICT_TRAININGS[name]
    return dict(recipe, dtype="float32")


def jax_dataset(ds):
    """The port's DataSet (``load_corpus``) as the JAX package's."""
    from koopman_realizations_tpu import types as jtypes

    def conv(trs):
        return [jtypes.Trial(t=tr.t, y=tr.y, u=tr.u, x=tr.x, w=tr.w)
                for tr in trs]
    return jtypes.DataSet(train=conv(ds.train), val=conv(ds.val),
                          params=ds.params)


def dict_zetas(nzeta: int, B: int, seed: int = 0) -> np.ndarray:
    """0.15 randn zetas of the model-in-the-loop lanes (f32)."""
    rng = np.random.default_rng(seed)
    return (0.15 * rng.standard_normal((B, nzeta))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_dict_model(name: str):
    """(model, scaler) of a dictionary asset (or the committed bilinear
    one), through the JAX loader."""
    from koopman_realizations_tpu.utils.checkpoint import load_model
    return load_model(str(dict_asset_path(name)))


def jax_dict_sim(path: str, qp_iters: int, model=None, scaler=None):
    """(Ksim, controller) of the JAX package for a ``DICT_PATHS`` entry at
    ``qp_iters`` (on ``model`` where given, else the asset's)."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.control.ksim import KoopmanPlant
    from koopman_realizations_tpu.models.arm import Arm
    asset, plant, knobs = DICT_PATHS[path]
    if model is None:
        model, scaler = jax_dict_model(asset)
    mpc = make_kmpc(model, scaler, MpcConfig(**dict(knobs,
                                                    qp_iters=qp_iters)))
    pl = KoopmanPlant(model, scaler) if plant == "model" \
        else Arm(ArmConfig(**BENCH_ARM))
    return Ksim(pl, mpc), mpc


def jax_dict_lanes(path: str, B: int, model=None):
    """(X0, W) of a path's B lanes: the bench's arm states, or the lifted
    0.15 randn zetas of the model in the loop."""
    asset, plant, _ = DICT_PATHS[path]
    if plant != "model":
        return bench_X0(B), np.zeros((B, 2), np.float32)
    if model is None:
        model = jax_dict_model(asset)[0]
    z = dict_zetas(model.meta.nzeta, B)
    X0 = np.asarray(jax.vmap(model.basis.lift)(jax.numpy.asarray(z)))
    return X0, np.zeros((B, 2), np.float32)


def jax_dict_run(path: str, qp_iters: int, B: int = REF_B,
                 steps: int = REF_STEPS, model=None, scaler=None):
    """The JAX general runner on a path: (per-lane err_mean, per-lane
    alive at the last step, Yp)."""
    sim, _ = jax_dict_sim(path, qp_iters, model, scaler)
    X0, W = jax_dict_lanes(path, B, model)
    run = sim.batched_runner(blockM_y(), steps=steps, record=("Yp", "alive"))
    out = jax.block_until_ready(run(X0, W))
    Yp = np.asarray(out["Yp"])
    return (lane_errors(Yp, blockM_y(), steps),
            np.asarray(out["alive"])[:, -1], Yp)


def _run_pool(code: str, tasks: list, procs: int, env: dict) -> dict:
    """Run ``python -c code *task`` for every task, ``procs`` processes at
    once, each one's standard output into a file (a pipe would fill);
    returns {task: the JSON of its last output line}."""
    import subprocess
    import tempfile
    import time
    tasks, done, running = list(tasks), {}, []
    while tasks or running:
        while tasks and len(running) < procs:
            t = tasks.pop(0)
            f = tempfile.TemporaryFile(mode="w+")
            running.append((t, f, subprocess.Popen(
                [sys.executable, "-c", code, *map(str, t)], stdout=f,
                text=True, env=env)))
        time.sleep(1.0)
        for item in [r for r in running if r[2].poll() is not None]:
            running.remove(item)
            t, f, proc = item
            f.seek(0)
            out = f.read()
            f.close()
            if proc.returncode:
                raise RuntimeError(f"the JAX run {t} failed")
            done[t] = json.loads(out.strip().splitlines()[-1])
    return done


def _jax_dict_f32(paths: dict, copies: int, seed: int = 0,
                  chunk: int = 12, procs: int = 8) -> dict:
    """Each path's JAX general runner with x64 off (f32 throughout) on its
    16 reference lanes at its qp_iters, for the asset (copy 0) and
    ``copies`` - 1 copies with every nonzero entry of its f32 A (W of a
    nonlinear model) moved one ulp up or down, copy k's directions from
    ``np.random.default_rng([seed, k])``; ``chunk`` copies a process,
    ``procs`` processes at once.  ``paths`` maps a path to its qp_iters.
    Returns {path: [[[alive, err_mean] per lane] per copy]}."""
    code = (
        "import dataclasses, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np\n"
        "import test_torch_oracle as O\n"
        "jax.config.update('jax_enable_x64', False)\n"
        "path, qp, k0, k1 = sys.argv[1], int(sys.argv[2]), "
        "int(sys.argv[3]), int(sys.argv[4])\n"
        "model, scaler = O.jax_dict_model(O.DICT_PATHS[path][0])\n"
        "name = 'W' if hasattr(model, 'W') else 'A'\n"
        "A = np.asarray(getattr(model, name), np.float32)\n"
        "lanes = []\n"
        "for k in range(k0, k1):\n"
        f"    rng = np.random.default_rng([{seed}, k])\n"
        "    up = rng.random(A.shape) < 0.5\n"
        "    Ak = A if k == 0 else np.where(A == 0, A, np.nextafter("
        "A, np.where(up, np.inf, -np.inf).astype(np.float32)))\n"
        "    mk = dataclasses.replace(model, **{name: Ak})\n"
        "    e, a, _ = O.jax_dict_run(path, qp, model=mk, scaler=scaler)\n"
        "    lanes.append([[bool(x), float(y)] for x, y in zip(a, e)])\n"
        "print(json.dumps(lanes))\n")
    tasks = [(path, qp, k0, min(k0 + chunk, copies))
             for path, qp in paths.items()
             for k0 in range(0, copies, chunk)]
    done = _run_pool(code, tasks, procs,
                     dict(os.environ, JAX_ENABLE_X64="0"))
    return {path: [lanes for t in sorted(k for k in done if k[0] == path)
                   for lanes in done[t]] for path in paths}


def write_dictionary_assets() -> dict:
    """Train the five ``DICT_ASSETS`` with the JAX package on the
    committed corpus and save them; returns their headers."""
    from koopman_realizations_tpu.config import SysidConfig as JSysid
    from koopman_realizations_tpu.models.edmd import Ksysid as JKsysid
    from koopman_realizations_tpu.utils.checkpoint import save_model
    from koopman_realizations_torch.utils.data import load_corpus
    ds = jax_dataset(load_corpus())
    out = {}
    for name, (fname, _) in DICT_ASSETS.items():
        path = ASSETS / fname
        ks = JKsysid(ds, JSysid(**dict_sysid(name))).train_models()
        save_model(str(path), ks.model, ks.scaler, overwrite=True)
        data = dict(np.load(path, allow_pickle=False))
        h = json.loads(str(data.pop("header")))
        h["provenance"] = {
            "corpus": "assets/arm3_corpus.npz (load_corpus)",
            "sysid": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in dict_sysid(name).items()},
            "written_by": "python tests/test_torch_oracle.py "
                          "--write-dictionaries"}
        np.savez(path, header=json.dumps(h), **data)
        out[fname] = h
        print(name, "N", ks.model.meta.N, flush=True)
    jax_dict_model.cache_clear()
    return out


def write_dictionary_refs(copies: int = DICT_F32_COPIES) -> dict:
    """Run every ``DICT_PATHS`` loop with the JAX general runner (x64,
    CPU, B=16 x 301 blockM steps) at the smallest qp_iters from
    ``DICT_QP_FROM`` that keeps all 16 lanes alive (or, where none up to
    ``DICT_QP_TO`` does, at ``DICT_QP_TO`` with the lanes' alive flags),
    then JAX's f32 runs of the same lanes (the asset and ``copies`` - 1
    one-ulp copies of A: each lane's band), and write ``DICT_REFS``."""
    import dataclasses
    paths = {}
    for path, (asset, plant, knobs) in DICT_PATHS.items():
        tried = {}
        for q in range(DICT_QP_FROM, DICT_QP_TO + 1):
            e, a, _ = jax_dict_run(path, q)
            tried[q] = float(a.mean())
            print(path, q, tried[q], float(e.mean()), flush=True)
            if a.all():
                break
        _, mpc = jax_dict_sim(path, q)
        paths[path] = {
            "asset": dict_asset_path(asset).name, "plant": plant,
            "knobs": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in knobs.items()},
            "qp_iters": q, "qp_search": tried,
            "config": dataclasses.asdict(mpc.cfg),
            "alive": [bool(v) for v in a],
            "err_mean": [float(v) for v in e],
            "err_worst": float(e.max())}
        print(json.dumps(paths[path]), flush=True)
    f32 = _jax_dict_f32({p: r["qp_iters"] for p, r in paths.items()},
                        copies)
    for path, per_copy in f32.items():
        e = np.asarray([[v for _, v in lanes] for lanes in per_copy])
        paths[path]["f32"] = {
            "alive": [a for a, _ in per_copy[0]],
            "all_alive": bool(all(a for lanes in per_copy
                                  for a, _ in lanes)),
            "alive_copies": [int(sum(lanes[i][0] for lanes in per_copy))
                             for i in range(len(per_copy[0]))],
            "copies": len(per_copy),
            "band": [[float(lo), float(hi)]
                     for lo, hi in zip(e.min(0), e.max(0))]}
        print(path, "f32 band width", float((e.max(0) - e.min(0)).max()),
              flush=True)
    refs = {
        "runner": "koopman_realizations_tpu Ksim.batched_runner "
                  "(jax_enable_x64, CPU)",
        "written_by": "python tests/test_torch_oracle.py "
                      "--write-dictionaries",
        "B": REF_B, "steps": REF_STEPS, "arm": BENCH_ARM,
        "X0": "arm: first joint spread over +-0.2 rad (bench_X0); model: "
              "the lift of 0.15 randn zetas (B, nzeta), default_rng(0)",
        "reference": "blockM([0.45, -0.35], 0.5, 0.5), T=15, Ts=0.05",
        "qp_iters": f"the smallest count from {DICT_QP_FROM} that keeps "
                    f"all 16 lanes alive (up to {DICT_QP_TO})",
        "f32": f"JAX with x64 off on the same lanes: the asset and "
               f"{copies - 1} copies with every nonzero of A (W of a "
               f"nonlinear model) moved one ulp (copy k's directions from "
               f"default_rng([0, k])); band = each "
               f"lane's [min, max] err_mean, alive_copies = the copies that "
               f"keep each lane alive",
        "sysid": {n: {k: list(v) if isinstance(v, tuple) else v
                      for k, v in dict_sysid(n).items()}
                  for n in (*DICT_ASSETS, *DICT_TRAININGS)},
        "assets": {n: f for n, (f, _) in DICT_ASSETS.items()},
        "paths": paths}
    refs["trainings"] = dictionary_trainings()
    DICT_REFS.write_text(json.dumps(refs, indent=1) + "\n")
    add_dictionary_full_width()
    return {k: v for k, v in refs.items() if k != "paths"}


# the model-in-the-loop path's full width: its lanes are random draws, so
# JAX x64's alive flags on all of them (not the 16 references') are what
# phase DX4 holds the card to
DICT_FULL_B, DICT_FULL_CHUNK = 65536, 4096


def _jax_dict_full_chunk(path: str, qp: int, a: int, b: int) -> list:
    """JAX x64's alive flags at the last step on lanes a..b of a path's
    DICT_FULL_B full-width lanes (``jax_dict_lanes``)."""
    sim, _ = jax_dict_sim(path, qp)
    X0, W = jax_dict_lanes(path, DICT_FULL_B)
    run = sim.batched_runner(blockM_y(), steps=REF_STEPS,
                             record=("Yp", "alive"))
    out = jax.block_until_ready(run(X0[a:b], W[a:b]))
    Yp = np.asarray(out["Yp"])
    return [np.asarray(out["alive"])[:, -1].tolist(),
            lane_errors(Yp, blockM_y(), REF_STEPS).tolist()]


def dictionary_full_width(paths: dict, x64: bool = True,
                          procs: int = 8) -> dict:
    """JAX, in x64 or with x64 off (f32 throughout), on every full-width
    lane of each model-in-the-loop path (``paths``: path -> qp_iters), in
    chunks of DICT_FULL_CHUNK lanes on ``procs`` processes: {path: {"B",
    "alive" (fraction), "dead" (lane indices), "err_mean" (over the alive
    lanes)}}."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import test_torch_oracle as O\n"
        + ("" if x64 else "O.jax.config.update('jax_enable_x64', False)\n")
        + "p, q, a, b = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), "
        "int(sys.argv[4])\n"
        "print(json.dumps(O._jax_dict_full_chunk(p, q, a, b)))\n")
    tasks = [(p, q, a, a + DICT_FULL_CHUNK) for p, q in paths.items()
             for a in range(0, DICT_FULL_B, DICT_FULL_CHUNK)]
    done = _run_pool(code, tasks, procs,
                     dict(os.environ, JAX_ENABLE_X64=str(int(x64))))
    out = {}
    for p in paths:
        chunks = [done[t] for t in sorted(k for k in done if k[0] == p)]
        alive = np.concatenate([np.asarray(c[0], bool) for c in chunks])
        err = np.concatenate([np.asarray(c[1]) for c in chunks])
        out[p] = {"B": DICT_FULL_B, "alive": float(alive.mean()),
                  "dead": np.nonzero(~alive)[0].tolist(),
                  "err_mean": float(err[alive].mean())}
        print(p, "x64" if x64 else "f32", "full width alive",
              out[p]["alive"], flush=True)
    return out


# the arm paths whose full-width alive fraction phase DX4 holds to JAX's
# f32 run on the same lanes: del1 loses lanes at full width on the card
# (alive 0.938, PERF.md §6) though all 16 reference lanes live
DICT_FULL_F32 = ("del1",)


def add_dictionary_full_width(only=None, procs: int = 8) -> dict:
    """Add ``dictionary_full_width`` of the model-in-the-loop paths, x64
    ("full") and f32 ("full_f32"), and of ``DICT_FULL_F32``'s arm paths,
    f32 only, to the committed ``DICT_REFS`` (``only``: those paths
    alone)."""
    refs = json.loads(DICT_REFS.read_text())
    keys = {p: (("full", True), ("full_f32", False))
            if r["plant"] == "model" else (("full_f32", False),)
            for p, r in refs["paths"].items()
            if r["plant"] == "model" or p in DICT_FULL_F32}
    if only:
        keys = {p: v for p, v in keys.items() if p in only}
    out = {}
    for key, x64 in (("full", True), ("full_f32", False)):
        paths = {p: refs["paths"][p]["qp_iters"] for p, ks in keys.items()
                 if (key, x64) in ks}
        if not paths:
            continue
        for p, v in dictionary_full_width(paths, x64, procs).items():
            refs["paths"][p][key] = v
            out[f"{p} {key}"] = {k: v[k] for k in ("B", "alive",
                                                   "err_mean")}
    DICT_REFS.write_text(json.dumps(refs, indent=1) + "\n")
    return out


DICT_ONE_STEP_ROWS = 50


def dictionary_trainings() -> dict:
    """JAX's training of each ``DICT_TRAININGS`` recipe on the committed
    corpus: its scaled one-step predictions of the first
    ``DICT_ONE_STEP_ROWS`` steps of the first validation trial (the
    port's ``one_step_predictions``, on the JAX model through the JAX
    ``save_model`` and the port's ``load_model``), which phase DX1 holds
    the card's training to."""
    import tempfile

    from koopman_realizations_tpu.config import SysidConfig as JSysid
    from koopman_realizations_tpu.models.edmd import Ksysid as JKsysid
    from koopman_realizations_tpu.utils.checkpoint import save_model
    from koopman_realizations_torch.utils.checkpoint import load_model
    from koopman_realizations_torch.utils.data import load_corpus
    from koopman_realizations_torch.utils.metrics import (
        one_step_predictions as port_one_step,
    )
    ds = jax_dataset(load_corpus())
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name in DICT_TRAININGS:
            ks = JKsysid(ds, JSysid(**dict_sysid(name))).train_models()
            tm = load_model(save_model(f"{d}/{name}", ks.model, ks.scaler))[0]
            p = port_one_step(tm, ks.valdata[:1], "cpu")[:DICT_ONE_STEP_ROWS]
            out[name] = {"N": int(ks.model.meta.N),
                         "one_step": [[float(v) for v in row] for row in p]}
            print(name, "N", ks.model.meta.N, flush=True)
    return out


# ---------------------------------------------------------------- tests


# ---- the default plant and angle outputs (``--write-angles``): the
# JAX general runner on ``ArmConfig()``'s defaults (SDIRK2 with a Jacobian
# every substep, 10 substeps, 3 Newton iterations) with the bench's arm
# geometry, for the main path's two assets on blockM and for two
# JAX-trained models on angle outputs tracking two joints
DEFAULT_ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1)
ANGLE_ARM = dict(DEFAULT_ARM, output_type="angles")
ANGLE_CORPUS_RECIPE = dict(trials=15, tf=60.0, n_val=5, seed=0,
                           arm=dict(DEFAULT_ARM, output_type="angles",
                                    substeps=5))
ANGLE_CORPUS = ASSETS / "arm3_angles_corpus.npz"
ANGLE_ASSETS = {"bilinear": ASSETS / "arm3_angles_bilinear_poly3.npz",
                "linear": ASSETS / "arm3_angles_linear_poly3.npz"}
ANGLE_MPC = {"bilinear": dict(BENCH_MPC, proj_idx=(0, 1)),
             "linear": dict(LINEAR_MPC, proj_idx=(0, 1))}
# the angle reference: joints 1 and 2 on sinusoids of 0.4 rad, periods
# 6 s and 4 s, 301 rows at Ts = 0.05 (written into RUNNER_REFS, which
# both packages read)
ANGLE_REF = dict(amplitude=0.4, periods=(6.0, 4.0), rows=301, Ts=0.05)
RUNNER_REFS = ASSETS / "runner_refs.json"
# path -> (kind, asset, controller, plant, reference)
RUNNER_PATHS = {
    "default_bilinear": ("bilinear", ASSET, BENCH_MPC, DEFAULT_ARM,
                         "blockM"),
    "default_linear": ("linear", LINEAR_ASSET, LINEAR_MPC, DEFAULT_ARM,
                       "blockM"),
    "angles_bilinear": ("bilinear", ANGLE_ASSETS["bilinear"],
                        ANGLE_MPC["bilinear"], ANGLE_ARM, "angles"),
    "angles_linear": ("linear", ANGLE_ASSETS["linear"],
                      ANGLE_MPC["linear"], ANGLE_ARM, "angles"),
}
RUNNER_QP_TO = 12


def angle_reference() -> np.ndarray:
    """The angle reference's rows (301, 2), as ``ANGLE_REF`` defines
    them."""
    r = ANGLE_REF
    t = np.arange(r["rows"]) * r["Ts"]
    return np.stack([r["amplitude"] * np.sin(2 * np.pi * t / T)
                     for T in r["periods"]], axis=1)


def runner_refs() -> dict:
    return json.loads(RUNNER_REFS.read_text())


def runner_reference(path: str) -> np.ndarray:
    """A runner path's reference rows: blockM, or the angle rows of
    ``RUNNER_REFS``."""
    ref = RUNNER_PATHS[path][4]
    return blockM_y() if ref == "blockM" \
        else np.asarray(runner_refs()["angle_reference"])


@functools.lru_cache(maxsize=None)
def jax_runner_sim(path: str, qp_iters: int = None):
    """(Ksim, controller) of the JAX package for a ``RUNNER_PATHS`` entry
    (at ``qp_iters``, else the path's own)."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.models.arm import Arm
    from koopman_realizations_tpu.utils.checkpoint import load_model
    kind, asset, mpc_cfg, arm, _ = RUNNER_PATHS[path]
    model, scaler = load_model(str(asset))
    knobs = dict(mpc_cfg) if qp_iters is None \
        else dict(mpc_cfg, qp_iters=qp_iters)
    mpc = make_kmpc(model, scaler, MpcConfig(**knobs))
    return Ksim(Arm(ArmConfig(**arm)), mpc), mpc


def jax_runner_run(path: str, qp_iters: int = None, B: int = REF_B,
                   steps: int = REF_STEPS, ref=None):
    """The JAX general runner on a runner path from the bench's initial
    states: (per-lane err_mean, per-lane alive at the last step, Yp)."""
    sim, _ = jax_runner_sim(path, qp_iters)
    ref = runner_reference(path) if ref is None else ref
    run = sim.batched_runner(ref, steps=steps, record=("Yp", "alive"))
    out = jax.block_until_ready(run(bench_X0(B), np.zeros((B, 2),
                                                           np.float32)))
    Yp = np.asarray(out["Yp"])
    return (lane_errors(Yp, ref, steps), np.asarray(out["alive"])[:, -1],
            Yp)


def write_angles() -> dict:
    """Generate the angle-output corpus, train the bilinear and linear
    poly-3 PCA f32 models on it with the JAX trainer, save the three, and
    write ``RUNNER_REFS``: each ``RUNNER_PATHS`` loop's JAX x64 general
    runner on 16 lanes over 301 steps (an angle path at the smallest
    qp_iters from its controller's that keeps all 16 lanes alive, up to
    ``RUNNER_QP_TO``), with the angle reference's rows."""
    import dataclasses

    from examples.generate_arm_data import generate
    from koopman_realizations_tpu.utils.checkpoint import save_model
    written_by = "python tests/test_torch_oracle.py --write-angles"
    r = ANGLE_CORPUS_RECIPE
    ds = generate(r["trials"], r["tf"], n_val=r["n_val"], seed=r["seed"],
                  cfg=ArmConfig(**r["arm"]))
    recipe = ("examples/generate_arm_data.py:generate(15, 60.0, n_val=5, "
              "seed=0, cfg=ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1, "
              "output_type='angles', substeps=5))")
    header = {"recipe": recipe + ", JAX x64 on the CPU",
              "written_by": written_by,
              "fields": "t [T], y [T, n], u [T, m] of each trial, f64",
              "split": {"train": len(ds.train), "val": len(ds.val)},
              "params": ds.params}
    arrays = {f"{split}{i}_{f}": np.asarray(getattr(tr, f), np.float64)
              for split in ("train", "val")
              for i, tr in enumerate(getattr(ds, split))
              for f in ("t", "y", "u")}
    np.savez(ANGLE_CORPUS, header=json.dumps(header), **arrays)
    out = {}
    for kind, path in ANGLE_ASSETS.items():
        ks = train_jax(ds, kind)
        save_model(str(path), ks.model, ks.scaler, overwrite=True)
        data = dict(np.load(path, allow_pickle=False))
        h = json.loads(str(data.pop("header")))
        h["provenance"] = {
            "corpus": recipe,
            "sysid": f"Ksysid {kind} poly-3 dim_red=True dtype=float32",
            "written_by": written_by}
        np.savez(path, header=json.dumps(h), **data)
        out[path.name] = {"NL": ks.model.meta.NL}
    RUNNER_REFS.write_text(json.dumps(
        {"angle_reference": angle_reference().tolist()}) + "\n")
    jax_runner_sim.cache_clear()
    paths = {}
    for name, (kind, asset, mpc_cfg, arm, ref) in RUNNER_PATHS.items():
        tried = {}
        q0 = mpc_cfg["qp_iters"]
        for q in range(q0, (RUNNER_QP_TO if ref == "angles" else q0) + 1):
            e, a, _ = jax_runner_run(name, q)
            tried[q] = float(a.mean())
            print(name, q, tried[q], float(e.mean()), flush=True)
            if a.all():
                break
        _, mpc = jax_runner_sim(name, q)
        paths[name] = {
            "asset": asset.name, "arm": arm, "reference": ref,
            "qp_iters": q, "qp_search": tried,
            "config": dataclasses.asdict(mpc.cfg),
            "alive": [bool(v) for v in a], "err_mean": [float(v) for v in e],
            "err_worst": float(e.max())}
    refs = {
        "runner": "koopman_realizations_tpu Ksim.batched_runner "
                  "(jax_enable_x64, CPU)",
        "written_by": written_by, "B": REF_B, "steps": REF_STEPS,
        "X0": "first joint spread over +-0.2 rad (bench_X0)",
        "plant": "ArmConfig() defaults (SDIRK2, substeps=10, newton_iters="
                 "3, jac_mode='substep') with Nmods=3, nlinks=1, L=1.0, "
                 "m=0.1; markers or angles",
        "references": {"blockM": "blockM([0.45, -0.35], 0.5, 0.5), T=15, "
                                 "Ts=0.05",
                       "angles": ANGLE_REF},
        "qp_iters": f"the controller's; an angle path the smallest count "
                    f"from it that keeps all 16 lanes alive (up to "
                    f"{RUNNER_QP_TO})",
        "angle_reference": angle_reference().tolist(),
        "paths": paths}
    RUNNER_REFS.write_text(json.dumps(refs, indent=1) + "\n")
    return {**out, **{k: {"qp_iters": v["qp_iters"],
                          "err_mean": float(np.mean(v["err_mean"])),
                          "alive": float(np.mean(v["alive"]))}
                      for k, v in paths.items()}}


# ---- the controller knobs (``--write-knob-refs``): the dual warm start
# and the dual stage shift, state bounds on unblocked stacks, and the
# lasso sweep's relinearized passes, each on the bench's arm and blockM
# from the bench's 16 initial states (the sweep: its six candidates)
# the outputs' range over the bench's loop (JAX x64, the bilinear asset,
# 4 of its lanes), which ``knob_state_bounds`` widens: the bilinear loop
# by 0.1 with the end effector's x capped at 0.7 (the unbounded loop
# reaches 0.704), alive from qp_iters=12; the linear one by 2.0, where its
# loop lives (its model's predictions leave a 1.0 margin within 60 steps
# and the QPs turn infeasible), with the end effector's x capped at 0.55
# (the unbounded loop reaches 0.654; a state-bound row binds on about a
# third of the lane-steps) and warm duals from qp_iters=16 (cold, the
# wide slacks need 24; at 8 every lane dies within 7 steps)
KNOB_Y_RANGE = ((-0.243, 0.145), (0.228, 0.333), (-0.148, 0.451),
                (0.370, 0.666), (-0.19, 0.704), (0.14, 0.9995))


def knob_state_bounds(margin: float, cap: float = None) -> tuple:
    """Per-output state bounds: ``KNOB_Y_RANGE`` widened by ``margin``,
    the end effector's x capped at ``cap`` (which the unbounded loop
    passes)."""
    sb = [[lo - margin, hi + margin] for lo, hi in KNOB_Y_RANGE]
    if cap is not None:
        sb[4][1] = cap
    return tuple(tuple(v) for v in sb)


KNOB_PATHS = {
    "linear_dual_warm": ("linear", dict(LINEAR_MPC, qp_dual_warm=True)),
    "linear_dual_shift": ("linear", dict(LINEAR_MPC, qp_dual_warm=True,
                                         qp_dual_shift=True)),
    "linear_unblocked_sb": ("linear", dict(
        LINEAR_MPC, input_blocks=None, qp_iters=16, qp_dual_warm=True,
        state_bounds=knob_state_bounds(2.0, 0.55))),
    "bilinear_dual_shift": ("bilinear", dict(BENCH_MPC, qp_dual_shift=True)),
    "bilinear_unblocked_sb": ("bilinear", dict(
        BENCH_MPC, input_blocks=None, qp_iters=12,
        state_bounds=knob_state_bounds(0.1, 0.7))),
}
KNOB_LASSO = dict(bilinear_iters=2)
KNOB_REFS = ASSETS / "knob_refs.json"
# a knob loop whose JAX f32 run parts from x64 by more than this on a
# lane (or loses another lane) amplifies f32 rounding: it gets the
# 96-copy band, as the dictionary paths do
KNOB_F32_EDGE = 1e-4


def jax_knob_sim(name: str, model=None, scaler=None):
    """(Ksim, controller) of the JAX package for a ``KNOB_PATHS`` entry on
    its asset (cached per process) or on ``model``."""
    from koopman_realizations_tpu.control import Ksim, make_kmpc
    from koopman_realizations_tpu.models.arm import Arm
    if model is None:
        return _jax_knob_sim_asset(name)
    mpc = make_kmpc(model, scaler, MpcConfig(**KNOB_PATHS[name][1]))
    return Ksim(Arm(ArmConfig(**BENCH_ARM)), mpc), mpc


@functools.lru_cache(maxsize=None)
def _jax_knob_sim_asset(name: str):
    return jax_knob_sim(name, *jax_model(KNOB_PATHS[name][0]))


def jax_knob_run(name: str, B: int = REF_B, steps: int = REF_STEPS,
                 model=None, scaler=None):
    """The JAX general runner on a knob path: (per-lane err_mean, per-lane
    alive at the last step, Yp)."""
    sim, _ = jax_knob_sim(name, model, scaler)
    run = sim.batched_runner(blockM_y(), steps=steps, record=("Yp", "alive"))
    out = jax.block_until_ready(run(bench_X0(B), np.zeros((B, 2),
                                                          np.float32)))
    Yp = np.asarray(out["Yp"])
    return (lane_errors(Yp, blockM_y(), steps),
            np.asarray(out["alive"])[:, -1], Yp)


def _jax_knob_f32(names: list, copies: int, seed: int = 0, chunk: int = 12,
                  procs: int = 8) -> dict:
    """Each knob path's JAX general runner with x64 off on its 16 lanes,
    for the asset (copy 0) and ``copies`` - 1 one-ulp copies of its A
    (as ``_jax_dict_f32``).  Returns {name: [[[alive, err_mean] per lane]
    per copy]}."""
    code = (
        "import dataclasses, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np\n"
        "import test_torch_oracle as O\n"
        "jax.config.update('jax_enable_x64', False)\n"
        "name, k0, k1 = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])\n"
        "model, scaler = O.jax_model(O.KNOB_PATHS[name][0])\n"
        "A = np.asarray(model.A, np.float32)\n"
        "lanes = []\n"
        "for k in range(k0, k1):\n"
        f"    rng = np.random.default_rng([{seed}, k])\n"
        "    up = rng.random(A.shape) < 0.5\n"
        "    Ak = A if k == 0 else np.where(A == 0, A, np.nextafter("
        "A, np.where(up, np.inf, -np.inf).astype(np.float32)))\n"
        "    mk = dataclasses.replace(model, A=Ak)\n"
        "    e, a, _ = O.jax_knob_run(name, model=mk, scaler=scaler)\n"
        "    lanes.append([[bool(x), float(y)] for x, y in zip(a, e)])\n"
        "print(json.dumps(lanes))\n")
    tasks = [(name, k0, min(k0 + chunk, copies)) for name in names
             for k0 in range(0, copies, chunk)]
    done = _run_pool(code, tasks, procs,
                     dict(os.environ, JAX_ENABLE_X64="0"))
    return {name: [lanes for t in sorted(k for k in done if k[0] == name)
                   for lanes in done[t]] for name in names}


# ---- the linear state-bound knob's lanes lost on the card
# (``--write-lost-lanes FILE``): the QPs that ``python3 chip_smoke.py
# --measure cold-lanes`` kept (cold duals, 24 iterations, the bounds the
# loop never reaches), with the JAX package's verdict on each in f32 and
# x64
LOST_LANES = ASSETS / "cold_lost_lanes.npz"


def write_lost_lanes(src) -> dict:
    """Copy the lost lanes' QPs of a ``cold-lanes`` report (``src``, its
    .npz) to ``LOST_LANES`` with JAX's ``solve_qp`` (shared A, the lane's
    primal start) on each at the loop's iterations and at twice them,
    with x64 off (a subprocess) and on: ok and gap a lane."""
    import subprocess
    d = np.load(src)
    h = json.loads(str(d["header"]))
    code = (
        "import json, sys\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', sys.argv[2] == '64')\n"
        "import numpy as np\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from koopman_realizations_tpu.ops.qp import solve_qp\n"
        "d = np.load(sys.argv[1])\n"
        "dt = np.float64 if sys.argv[2] == '64' else np.float32\n"
        "P, A = (d[k].astype(dt) for k in ('Psh', 'A'))\n"
        "out = {}\n"
        "for k in map(int, sys.argv[3:]):\n"
        "    f = jax.vmap(lambda q, b, x0: solve_qp(P, q, A, b, iters=k, "
        "x0=x0, shared_A=True))\n"
        "    sol = f(*(d[v].T.astype(dt) for v in ('q', 'b', 'x0')))\n"
        "    out[k] = {'ok': np.asarray(sol.ok).tolist(), 'gap': "
        "[float(g) for g in np.asarray(sol.gap)]}\n"
        "print(json.dumps(out))\n")
    its = [h["iters"], 2 * h["iters"]]
    jax_ = {}
    for bits in ("32", "64"):
        res = subprocess.run(
            [sys.executable, "-c", code, str(src), bits, *map(str, its)],
            capture_output=True, text=True, check=True,
            env=dict(os.environ, JAX_ENABLE_X64="1" if bits == "64"
                     else "0"))
        jax_["f" + bits] = json.loads(res.stdout.strip().splitlines()[-1])
    h.update(jax=jax_, written_by="python tests/test_torch_oracle.py "
             "--write-lost-lanes FILE (FILE: python3 chip_smoke.py "
             "--measure cold-lanes)")
    np.savez(LOST_LANES, header=json.dumps(h),
             **{k: d[k] for k in d.files if k != "header"})
    return jax_


def jax_lasso_candidates_models():
    """(ks-like namespace with the JAX models of ``LASSO_CANDIDATES`` and
    their scaler): the port's reading of the candidates, through
    ``save_model`` and the JAX ``load_model``."""
    import tempfile
    import types

    from koopman_realizations_tpu.utils.checkpoint import load_model
    from koopman_realizations_torch.utils.checkpoint import (
        save_model as tsave,
    )
    cands, scaler = port_lasso_candidates()
    with tempfile.TemporaryDirectory() as d:
        ms = [load_model(tsave(f"{d}/c{i}", cd, scaler))
              for i, cd in enumerate(cands)]
    return types.SimpleNamespace(candidates=[m for m, _ in ms],
                                 scaler=ms[0][1], basis=ms[0][0].basis)


def write_knob_refs(copies: int = F32_COPIES, procs: int = 8,
                    only=None) -> dict:
    """Run every ``KNOB_PATHS`` loop with the JAX general runner (x64,
    CPU, B=16 x 301 blockM steps) and its f32 run; where the f32 run parts
    from x64 by more than ``KNOB_F32_EDGE`` on a lane (or another lane
    dies), also ``copies`` - 1 one-ulp copies of A, each lane's band.
    Then the JAX lasso sweep of ``LASSO_CANDIDATES`` with ``KNOB_LASSO``
    on top of ``LASSO_SWEEP``'s controller, x64 and its f32 lanes (the
    candidate and one-ulp copies, ``_jax_sweep_f32``).  Writes
    ``KNOB_REFS``; with ``only`` (path names) it reruns those paths alone
    and keeps the rest of the committed file."""
    import dataclasses

    from koopman_realizations_tpu.models.arm import Arm
    from koopman_realizations_tpu.workflows.lasso_sweep import (
        lasso_sweep_closed_loop,
    )
    paths = {}
    for name, (kind, knobs) in KNOB_PATHS.items():
        if only and name not in only:
            continue
        e, a, _ = jax_knob_run(name)
        _, mpc = jax_knob_sim(name)
        paths[name] = {
            "asset": MODELS[kind][0].name,
            "knobs": {k: [list(x) if isinstance(x, tuple) else x for x in v]
                      if isinstance(v, tuple) else v
                      for k, v in knobs.items()},
            "config": dataclasses.asdict(mpc.cfg),
            "alive": [bool(v) for v in a], "err_mean": [float(v) for v in e],
            "err_worst": float(e.max())}
        print(name, float(a.mean()), float(e.mean()), flush=True)
    first = _jax_knob_f32(list(paths), 1, procs=procs)
    wide = []
    for name, per_copy in first.items():
        r = paths[name]
        lanes = per_copy[0]
        off = max(abs(v - x) for (_, v), x in zip(lanes, r["err_mean"]))
        if off > KNOB_F32_EDGE or any(al != x for (al, _), x in
                                      zip(lanes, r["alive"])):
            wide.append(name)
        r["f32"] = {"alive": [al for al, _ in lanes], "copies": 1,
                    "off_x64": off,
                    "band": [[v, v] for _, v in lanes]}
    if wide:
        more = _jax_knob_f32(wide, copies, procs=procs)
        for name, per_copy in more.items():
            e = np.asarray([[v for _, v in lanes] for lanes in per_copy])
            paths[name]["f32"].update(
                copies=len(per_copy),
                alive_copies=[int(sum(lanes[i][0] for lanes in per_copy))
                              for i in range(len(per_copy[0]))],
                all_alive=bool(all(al for lanes in per_copy
                                   for al, _ in lanes)),
                band=[[float(lo), float(hi)]
                      for lo, hi in zip(e.min(0), e.max(0))])
    for r in paths.values():
        f = r["f32"]
        f.setdefault("all_alive", all(f["alive"]))
        f.setdefault("alive_copies", [int(al) for al in f["alive"]])
    if only:
        refs = json.loads(KNOB_REFS.read_text())
        refs["paths"].update(paths)
        KNOB_REFS.write_text(json.dumps(refs, indent=1) + "\n")
        return {k: (float(np.mean(v["alive"])), float(np.mean(v["err_mean"])),
                    v["f32"]["copies"]) for k, v in paths.items()}
    # the lasso sweep with relinearized passes
    ks = jax_lasso_candidates_models()
    sweep = dict(LASSO_SWEEP, mpc=dict(LASSO_SWEEP["mpc"], **KNOB_LASSO))
    mcfg = MpcConfig(**sweep["mpc"])
    out = lasso_sweep_closed_loop(ks, Arm(ArmConfig(**sweep["arm"])), mcfg,
                                  blockM_y(), steps=sweep["steps"])
    err, alive = np.asarray(out["err"]), np.asarray(out["alive"])
    jax32 = _jax_sweep_f32(ks, copies, F32_SEED, mpc=KNOB_LASSO)
    cands = {}
    for i, lv in enumerate(out["lasso"]):
        em, al = float(err[i].mean()), bool(alive[i, -1])
        f32 = jax32[i * copies:(i + 1) * copies]
        ems = [v for _, v in f32] + [em]
        cands[str(lv)] = {
            "lasso": lv, "alive": al, "err_mean": em,
            "err_worst": float(err[i].max()),
            "f32_stable": all(a_ == al and abs(v - em) < 1e-3
                              for a_, v in f32),
            "f32_band": [min(ems), max(ems)],
            "f32_alive": [a_ for a_, _ in f32]}
        print("lasso", lv, cands[str(lv)]["err_mean"],
              cands[str(lv)]["f32_band"], flush=True)
    refs = {
        "runner": "koopman_realizations_tpu Ksim.batched_runner "
                  "(jax_enable_x64, CPU); lasso: workflows/lasso_sweep."
                  "lasso_sweep_closed_loop",
        "written_by": "python tests/test_torch_oracle.py --write-knob-refs",
        "B": REF_B, "steps": REF_STEPS, "arm": BENCH_ARM,
        "X0": "first joint spread over +-0.2 rad (bench_X0)",
        "reference": "blockM([0.45, -0.35], 0.5, 0.5), T=15, Ts=0.05",
        "f32": f"JAX with x64 off on the same lanes: the asset, and where "
               f"it parts from x64 by more than {KNOB_F32_EDGE} on a lane "
               f"(or keeps another lane alive) {copies - 1} copies with "
               f"every nonzero of A moved one ulp (copy k's directions "
               f"from default_rng([0, k])); band = each lane's [min, max] "
               f"err_mean",
        "paths": paths,
        "lasso": {"recipe": {"arm": sweep["arm"],
                             "mpc": {k: list(v) if isinstance(v, tuple)
                                     else v for k, v in sweep["mpc"].items()},
                             "steps": sweep["steps"]},
                  "candidates_file": LASSO_CANDIDATES.name,
                  "config": dataclasses.asdict(mcfg),
                  "f32": f"{copies} lanes a candidate (as trained and A "
                         f"moved one ulp, seed {F32_SEED}), JAX x64 off",
                  "candidates": cands}}
    KNOB_REFS.write_text(json.dumps(refs, indent=1) + "\n")
    return {k: (float(np.mean(v["alive"])), float(np.mean(v["err_mean"])),
                v["f32"]["copies"]) for k, v in paths.items()}


def test_asset_loads_identically_in_both_packages():
    from koopman_realizations_torch.utils.checkpoint import load_model
    jm, js = jax_model()
    tm, ts, header = load_model(ASSET)
    for name in ("A", "B", "C"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(tm, name))
    np.testing.assert_array_equal(np.asarray(jm.basis.pcs), tm.basis.pcs)
    for name in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name))
    assert tm.meta.NL == jm.meta.NL == 28
    assert tm.basis.families == jm.basis.families
    assert header["jax_reference"]["alive"] == 1.0


def test_from_jax_arrays_round_trip():
    import dataclasses

    from koopman_realizations_torch.models.koopman import from_jax_arrays
    jm, js = jax_model()
    header = {"meta": dataclasses.asdict(jm.meta),
              "basis": {"model_type": jm.basis.model_type, "n": jm.basis.n,
                        "m": jm.basis.m, "nd": jm.basis.nd,
                        "nw": jm.basis.nw,
                        "families": [list(f) for f in jm.basis.families]}}
    arrays = {"A": np.asarray(jm.A), "B": np.asarray(jm.B),
              "C": np.asarray(jm.C), "pcs": np.asarray(jm.basis.pcs)}
    arrays.update({"scaler_" + k: np.asarray(getattr(js, k))
                   for k in ("y_factor", "y_offset", "u_factor",
                             "u_offset")})
    tm, ts = from_jax_arrays(header, arrays)
    z = np.random.default_rng(0).standard_normal(6)
    np.testing.assert_allclose(
        tm.basis.lift(torch.from_numpy(z[:, None]))[:, 0].numpy(),
        np.asarray(jm.basis.lift(z)), rtol=1e-13, atol=1e-14)
    np.testing.assert_array_equal(tm.B, np.asarray(jm.B))
    np.testing.assert_array_equal(ts.u_factor, np.asarray(js.u_factor))
    assert tm.meta == type(tm.meta)(**dataclasses.asdict(jm.meta))


def test_asset_provenance_retrain():
    """Retraining on the generated corpus reproduces the asset's one-step
    predictions (predictions, not raw matrices: PCA signs may flip across
    LAPACK builds)."""
    ks = train_jax(generate_corpus())
    jm, js = jax_model()
    for k in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_allclose(np.asarray(getattr(ks.scaler, k)),
                                   np.asarray(getattr(js, k)), rtol=1e-12)
    p_new = one_step_predictions(ks.model, ks.valdata)
    p_asset = one_step_predictions(jm, ks.valdata)
    assert np.abs(p_new - p_asset).max() < 1e-5


def test_linear_asset_loads_identically_in_both_packages():
    from koopman_realizations_torch.models.koopman import LinearModel
    from koopman_realizations_torch.utils.checkpoint import (
        LINEAR_MODEL,
        load_model,
    )
    jm, js = jax_model("linear")
    tm, ts, header = load_model(LINEAR_MODEL)
    assert isinstance(tm, LinearModel) and tm.B.shape == (28, 3)
    for name in ("A", "B", "C"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(tm, name))
    np.testing.assert_array_equal(np.asarray(jm.basis.pcs), tm.basis.pcs)
    for name in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name))
    assert tm.meta.NL == jm.meta.NL == 28
    assert tm.meta.model_type == "linear"
    assert tm.basis.families == jm.basis.families
    ref = header["jax_reference"]
    assert ref["alive"] == 1.0
    assert ref["controller"] == "qp_iters=6 qp_dual_warm=False"


def test_linear_asset_provenance_retrain():
    """Retraining the linear model on the generated corpus reproduces the
    linear asset's one-step predictions C (A z + B u)."""
    ks = train_jax(generate_corpus(), "linear")
    jm, js = jax_model("linear")
    for k in ("y_factor", "y_offset", "u_factor", "u_offset"):
        np.testing.assert_allclose(np.asarray(getattr(ks.scaler, k)),
                                   np.asarray(getattr(js, k)), rtol=1e-12)
    p_new = one_step_predictions(ks.model, ks.valdata)
    p_asset = one_step_predictions(jm, ks.valdata)
    assert np.abs(p_new - p_asset).max() < 1e-5



def test_corpus_asset_matches_generator():
    """The committed corpus the port trains on is the generator's: t, y
    and u of every train and validation trial bitwise, the same split and
    params."""
    from koopman_realizations_torch.utils.data import CORPUS, load_corpus
    assert CORPUS == CORPUS_ASSET
    ds, committed = generate_corpus(), load_corpus(CORPUS)
    assert committed.params == ds.params
    for split in ("train", "val"):
        gen, com = getattr(ds, split), getattr(committed, split)
        assert len(com) == len(gen)
        for tg, tc in zip(gen, com):
            for f in ("t", "y", "u"):
                np.testing.assert_array_equal(getattr(tc, f),
                                              np.asarray(getattr(tg, f)))
                assert getattr(tc, f).dtype == np.float64

def test_sweep_refs_recipes_are_chip_smokes():
    """The recipes in the headers of the lasso-sweep and random-system
    references are the constants chip_smoke.py's phases LS and RS run,
    and each lasso candidate's f32 band and stability are those of its
    JAX f32 runs."""
    import chip_smoke
    norm = lambda d: json.loads(json.dumps(d))
    lasso = json.loads(LASSO_SWEEP_REFS.read_text())
    rand = json.loads(RAND_MODELS_REFS.read_text())
    assert chip_smoke.LASSO_REFS == LASSO_SWEEP_REFS
    assert chip_smoke.RAND_REFS == RAND_MODELS_REFS
    assert norm(chip_smoke.LASSO_SWEEP) == norm(LASSO_SWEEP) == {
        k: lasso["recipe"][k] for k in LASSO_SWEEP}
    assert set(lasso["candidates"]) == {str(v) for v in LASSO_SWEEP["lasso"]}
    # what phase LS reads of each candidate's JAX f32 runs
    for c in lasso["candidates"].values():
        ems = [e for _, e in c["f32_runs"]] + [c["err_mean"]]
        assert len(c["f32_runs"]) == F32_COPIES
        assert c["f32_band"] == [min(ems), max(ems)]
        assert c["f32_stable"] == all(
            a == c["alive"] and abs(e - c["err_mean"]) < 1e-3
            for a, e in c["f32_runs"])
    assert chip_smoke.PCA_EXPLAINED["bilinear"] == PCA_EXPLAINED["bilinear"]
    assert chip_smoke.TRAIN_RECIPE == dict(
        obs_type=("poly",), obs_degree=(3,), dim_red=True, dtype="float32")
    assert norm(chip_smoke.RAND_MODELS) == norm(RAND_MODELS) \
        == rand["recipe"]
    for fam, n in (("linear", 13), ("bilinear", 6), ("nonlinear", 4)):
        assert len(rand["families"][fam]["median"]) == n


def test_lasso_candidates_asset_in_the_ports_basis():
    """The JAX trainer's lasso candidates (``LASSO_CANDIDATES``) read by
    chip_smoke.py and re-signed to the port's PCA basis of the same
    training: the six lasso values of the recipe, and each model's scaled
    one-step predictions those of the model in its own basis (1e-9;
    re-signing is exact, the two bases' components part by ~1e-14)."""
    import chip_smoke
    from koopman_realizations_torch.config import SysidConfig as TConfig
    from koopman_realizations_torch.models.edmd import Ksysid as TKsysid
    from koopman_realizations_torch.models.koopman import from_jax_arrays
    from koopman_realizations_torch.utils.data import load_corpus
    from koopman_realizations_torch.utils.metrics import (
        one_step_predictions as t_one_step,
    )
    assert chip_smoke.LASSO_CANDIDATES == LASSO_CANDIDATES
    port = TKsysid(load_corpus(), TConfig(
        model_type="bilinear", obs_type=("poly",), obs_degree=(3,),
        dim_red=True, dtype="float32"), device="cpu")
    # every other component flipped, as another SVD may return them
    flip = np.where(np.arange(port.basis.pcs.shape[1]) % 2, -1.0, 1.0)
    port.basis = port.basis.with_pcs(port.basis.pcs * flip)
    aligned = chip_smoke.jax_lasso_candidates(port.basis, port.scaler)
    data = np.load(LASSO_CANDIDATES)
    header = json.loads(str(data["header"]))
    assert header["lasso"] == list(LASSO_SWEEP["lasso"])
    shared = {k: data[k] for k in data.files
              if k != "header" and not k.startswith(("A_", "B_"))}
    for i, m in enumerate(aligned):
        own = from_jax_arrays(dict(header, lasso=header["lasso"][i]),
                              dict(shared, A=data[f"A_{i}"],
                                   B=data[f"B_{i}"]))[0]
        assert m.lasso == header["lasso"][i] and m.basis is port.basis
        d = np.abs(t_one_step(m, port.valdata, "cpu")
                   - t_one_step(own, port.valdata, "cpu")).max()
        assert d < 1e-9, (i, d)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write-asset", nargs="*", choices=tuple(MODELS),
                    metavar="KIND",
                    help="retrain and rewrite the committed model assets of "
                         "these kinds (all of them when none is named)")
    ap.add_argument("--write-corpus", action="store_true",
                    help="write the generated corpus's t, y, u to "
                         "assets/arm3_corpus.npz")
    ap.add_argument("--write-regime-refs", action="store_true",
                    help="record the JAX general runner's quality in every "
                         "SQP regime of NMPC_REGIMES (nmpc_regime_refs.json)")
    ap.add_argument("--write-bilinear-refs", action="store_true",
                    help="record the JAX general runner's quality in every "
                         "bilinear configuration of BILINEAR_ROUTES "
                         "(bilinear_route_refs.json)")
    ap.add_argument("--write-lasso-refs", action="store_true",
                    help="record the JAX lasso sweep's quality per "
                         "candidate of LASSO_SWEEP (lasso_sweep_refs.json)")
    ap.add_argument("--write-loaded", action="store_true",
                    help="write the loaded experiment's corpus, its two "
                         "JAX-trained assets and loaded_refs.json")
    ap.add_argument("--write-loaded-refs", action="store_true",
                    help="rerun the JAX runs of loaded_refs.json on the "
                         "committed loaded assets")
    ap.add_argument("--write-dictionaries", action="store_true",
                    help="train the five dictionary assets with JAX on the "
                         "committed corpus and write dictionary_refs.json")
    ap.add_argument("--write-dictionary-refs", action="store_true",
                    help="rerun only the JAX runs of dictionary_refs.json "
                         "on the committed dictionary assets")
    ap.add_argument("--write-dictionary-full", nargs="*", metavar="PATH",
                    help="rerun only the JAX full-width runs of "
                         "dictionary_refs.json (the named paths, or all)")
    ap.add_argument("--procs", type=int, default=8,
                    help="JAX processes at once (--write-dictionary-full, "
                         "--write-knob-refs)")
    ap.add_argument("--write-angles", action="store_true",
                    help="write the angle-output corpus, its two "
                         "JAX-trained assets and runner_refs.json")
    ap.add_argument("--write-knob-refs", nargs="*", metavar="PATH",
                    help="record the JAX general runner's quality in every "
                         "controller knob of KNOB_PATHS (knob_refs.json; "
                         "the named paths alone, the rest kept)")
    ap.add_argument("--write-lost-lanes", metavar="FILE",
                    help="copy the lost lanes' QPs of a chip_smoke.py "
                         "--measure cold-lanes report (its .npz) to "
                         "assets/cold_lost_lanes.npz with JAX's verdict")
    ap.add_argument("--write-rand-refs", action="store_true",
                    help="record the JAX random-system sweep of RAND_MODELS"
                         " (rand_models_refs.json)")
    args = ap.parse_args()
    if args.write_asset is None and not (
            args.write_corpus or args.write_regime_refs
            or args.write_bilinear_refs or args.write_lasso_refs
            or args.write_rand_refs or args.write_loaded
            or args.write_loaded_refs or args.write_dictionaries
            or args.write_dictionary_refs or args.write_angles
            or args.write_knob_refs is not None
            or args.write_lost_lanes is not None
            or args.write_dictionary_full is not None):
        ap.error("nothing to do (pass --write-asset, --write-corpus, "
                 "--write-regime-refs, --write-bilinear-refs, "
                 "--write-lasso-refs, --write-rand-refs, --write-loaded, "
                 "--write-loaded-refs, --write-dictionaries, "
                 "--write-dictionary-refs, --write-dictionary-full, "
                 "--write-angles, --write-knob-refs or "
                 "--write-lost-lanes)")
    if args.write_corpus:
        print(json.dumps(write_corpus(), indent=1))
    if args.write_asset is not None:
        print(json.dumps(write_assets(tuple(args.write_asset)
                                      or tuple(MODELS)), indent=1))
    if args.write_regime_refs:
        print(json.dumps(write_regime_refs(), indent=1))
    if args.write_bilinear_refs:
        print(json.dumps(write_bilinear_refs(), indent=1))
    if args.write_lasso_refs:
        print(json.dumps(write_lasso_refs(), indent=1))
    if args.write_rand_refs:
        print(json.dumps(write_rand_refs(), indent=1))
    if args.write_loaded:
        print(json.dumps(write_loaded(), indent=1))
    elif args.write_loaded_refs:
        print(json.dumps(write_loaded_refs(), indent=1))
    if args.write_dictionaries:
        print(json.dumps(write_dictionary_assets(), indent=1))
    if args.write_dictionaries or args.write_dictionary_refs:
        print(json.dumps(write_dictionary_refs(), indent=1))
    if args.write_dictionary_full is not None:
        print(json.dumps(add_dictionary_full_width(
            args.write_dictionary_full, args.procs), indent=1))
    if args.write_angles:
        print(json.dumps(write_angles(), indent=1))
    if args.write_lost_lanes is not None:
        print(json.dumps(write_lost_lanes(args.write_lost_lanes), indent=1))
    if args.write_knob_refs is not None:
        print(json.dumps(write_knob_refs(procs=args.procs,
                                         only=args.write_knob_refs),
                         indent=1))
