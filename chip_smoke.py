"""GPU smoke run of the PyTorch/CUDA port (``koopman_realizations_torch``).

Run from the root of a checkout on a machine with an NVIDIA GPU (H100) and
the CUDA toolkit:

    python chip_smoke.py

It builds the ten CUDA kernels of the three closed loops from ``csrc/``
(one nvcc per build, all in parallel) and holds each against its plain
PyTorch version on the card.  For the bilinear bench controller and the
linear one it checks the fused loop's tracking quality against the JAX
reference value recorded in the model asset, drives the fused closed loop
at the bench's size (B=262144 lanes, 301 blockM steps) and the general
runner at B=65536; for the SQP NMPC controller, which has no fused step,
it checks the general runner's quality at B=16 and drives it at B=65536
(phases N1-N6), in its default regime (``nmpc_multipass``) and in the
regimes off that route (phases S1-S4: ``nmpc_stage`` and ``nmpc_pass``
against their plain versions, the B=16 quality of every regime of
``assets/nmpc_regime_refs.json`` against the JAX runner's, the stage and
chord routes at B=65536, the kernels' times, each beside its build's
group plan and ``ptxas -v`` line).  The bilinear controller
off the lift-fused route runs in phases R1-R4: ``bilin`` and the three
builds of ``ipm_factored`` against their plain versions on closed-loop
lanes, the B=16 quality of the configurations of
``assets/bilinear_route_refs.json`` against the JAX runner's, iterated
relinearization and the unblocked stack at B=65536, the kernels' times
(``bilin`` also by launch, with its plan and ``ptxas -v`` line).  Phase
Q3 holds ``batch_chol`` at n=12 and n=27 to its plain version and times
it beside ``torch.linalg.solve``, each build's plan and ``ptxas -v``
line logged.  Each main path runs with the launch counts set to 0 just
before and read just after; every kernel is timed at its path's shapes
next to its bound and its plain version (the fused steps in phases 6 and
L6 also by launch, the front and the group solve, with their builds'
plans and ``ptxas -v`` lines; the two-launch wrappers count calls, and
the first timing of each build counts the device launches of one call
with ``torch.profiler``, over 10 calls).  Phase P profiles a few steps
each of the unblocked route and the NMPC multipass route, and both fused
main paths whole, with ``torch.profiler``: device time by kernel and the
device's idle share.  Phase T runs the main path from its first stage:
the port's trainer (``models/edmd.py:Ksysid``) fits the bilinear, linear
and nonlinear models on the card from the committed corpus
(``assets/arm3_corpus.npz``), each stage timed with CUDA events; they are
held to the same training on the CPU and to the committed assets, saved
and reloaded, and drive both fused loops at B=262144 and the three
general runners at B=16 against the JAX references.  Phase LS trains a
lasso sweep's candidates on the card (FISTA) and runs them as lanes of
one closed loop through the per-lane-P ``ipm_shared`` build beside the
JAX trainer's candidates, against ``assets/lasso_sweep_refs.json``;
phase RS simulates and sweeps the random-system ensemble (460 fits) on
the card and the CPU against ``assets/rand_models_refs.json``.  Phase LD
runs the loaded-arm experiment with the load observer.  Phase DX runs
every dictionary of the JAX trainer from training to the closed loop
(``assets/dictionary_refs.json``): the five dictionary assets' recipes
and four more trained on the card (hermite, full fourier, two
continuous-time), the new builds of ``bilin_lift`` (a delayed model,
nz=15), ``bilin`` (NL=84 without PCA, NL=19 fourier_sparser) and
``nmpc_pass`` (the jacfwd route) against their plain versions, and
eight loops (delays, no PCA, fourier_sparser blocked, unblocked and
with the model in the loop, poly + gaussian linear, the jacfwd NMPC on a
fourier_sparser model and on a bilinear one) at B=16 against the JAX
references and at B=65536 x 301 through their kernels.  Phase NU runs
the NMPC's unblocked stack (``input_blocks=None``, n=27) in every route
through the wide builds of ``nmpc_multipass``, ``nmpc_stage``,
``nmpc_pass`` and ``ipm_factored``'s q0 build (the default at
B=65536 x 301), its state bounds on the plain per-lane interior point,
and a loaded model with delays under the load observer, against
``assets/nmpc_unblocked_refs.json`` and
``assets/loaded_delays_refs.json``.  Phase GN runs the arm plant in
full and data generation without JAX: the three committed corpora
regenerated on the card, the generator at 65536 trials, generate ->
``.mat`` -> train -> the fused loop, the main bilinear controller on the
'rk4', 'stage' and 'rk45' plants against ``assets/plant_refs.json``,
and the stage-wise LQ solvers and unrolled small solves against the CPU.
It prints the card's name and power limit, one JSON line with every
kernel's launches, device launches a call, error, times and bound, and
as the last line {"ok": true, "device": {...}}.  Any failed phase raises; without CUDA or
outside a checkout it exits non-zero and prints no result.

    python chip_smoke.py --measure NAME --out FILE [options]

runs one measurement beside the smoke run instead (``measure``): the
port's own f32 band of a dictionary loop, a loop's kernel solves shadowed
by plain f32 and f64, the linear state-bound loop's lost lanes, their
QPs by iterations, the general runners' wall times.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

# bench configuration (bench.py:95-122 of the JAX package)
MPC = dict(horizon=10, qp_iters=4, qp_dual_warm=True,
           input_blocks=(1, 1, 2, 5),
           input_bounds=(-7 * 3.141592653589793 / 8,
                         7 * 3.141592653589793 / 8),
           input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
           cost_input=(0.1 * 3e-2, 0.1 * 2e-2, 0.1 * 1e-2), proj_idx=(4, 5))
# the linear controller: the bench's horizon, blocks, bounds and costs at
# qp_iters=6 with cold duals (tests/test_torch_oracle.py:LINEAR_MPC)
LINEAR_MPC = dict(MPC, qp_iters=6, qp_dual_warm=False)
# the SQP NMPC controller: the same at qp_iters=8, cold duals, the default
# SQP regime (tests/test_torch_oracle.py:NMPC_MPC)
NMPC_MPC = dict(MPC, qp_iters=8, qp_dual_warm=False)
ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
           substeps=3, newton_iters=1, jac_mode="step")
# the SQP regimes off the multipass route with the JAX general runner's
# quality in each (tests/test_torch_oracle.py --write-regime-refs); two
# run at full width: the stage route in its 'hold'/'roll' modes and the
# chord route
REGIME_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "nmpc_regime_refs.json"
FULL_REGIMES = ("damping_decay", "jac_period")
# the bilinear controller off the lift-fused route, with the JAX general
# runner's quality in each (tests/test_torch_oracle.py
# --write-bilinear-refs); iters2 and unblocked run at full width
ROUTE_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "bilinear_route_refs.json"
FULL_ROUTES = ("iters2", "unblocked")
# the SQP regime whose every pass runs ipm_factored's q0 build (the
# infeasible-path 'linear' between-pass update); it runs at full width
LINEAR_REGIME = "linear_update"
# the recipe of the three model assets (tests/test_torch_oracle.py:
# train_jax): poly-3, PCA at 99 % (99.99 % for the nonlinear model), f32
# lift, on the committed corpus (assets/arm3_corpus.npz)
TRAIN_RECIPE = dict(obs_type=("poly",), obs_degree=(3,), dim_red=True,
                    dtype="float32")
PCA_EXPLAINED = {"bilinear": 99.0, "linear": 99.0, "nonlinear": 99.99}
# the closed-loop lasso sweep (phase LS; tests/test_torch_oracle.py:
# LASSO_SWEEP, whose JAX quality per candidate is in
# assets/lasso_sweep_refs.json): the bilinear asset recipe at six lasso
# values with the trainer's default FISTA cap and tol, then JAX
# tests/test_lasso_sweep.py's controller (unblocked, 12 iterations: n=27,
# mc=108) and plant (SDIRK2, 5 substeps, 3 Newton iterations, a Jacobian
# each substep) over 301 blockM steps
LASSO_SWEEP = dict(
    lasso=(2.0, 4.0, 8.0, 16.0, 32.0, float("inf")),
    lasso_iters=50000, lasso_tol=1e-12, steps=301,
    arm=dict(Nmods=3, nlinks=1, L=1.0, m=0.1, output_type="markers",
             substeps=5),
    mpc=dict(horizon=10, input_bounds=(-7 * 3.141592653589793 / 8,
                                       7 * 3.141592653589793 / 8),
             input_slopeConst=1e-1, cost_running=10.0, cost_terminal=100.0,
             cost_input=(3e-3, 2e-3, 1e-3), proj_idx=(4, 5)))
LASSO_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "lasso_sweep_refs.json"
# the JAX trainer's six candidates behind those references
LASSO_CANDIDATES = LASSO_REFS.with_name("lasso_sweep_candidates.npz")
# the random-system sweep at the reference's scale (phase RS;
# tests/test_torch_oracle.py:RAND_MODELS, assets/rand_models_refs.json):
# 20 systems of 10 training trials and 1 validation trial, 460 fits
RAND_MODELS = dict(
    seed=0, num_sys=20, num_terms=5, degree_x=3, degree_u=1, t_end=25.0,
    Ts=0.05, num_trials=11, max_degree_linear=13, max_degree_bilinear=6,
    max_degree_nonlinear=4, nonlinear_lasso=4.0, lasso_iters=500)
RAND_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "rand_models_refs.json"
# the paper's loaded-arm experiment (phase LD; BASELINE.md row 5): its
# recipe, controller and JAX references, written by
# tests/test_torch_oracle.py --write-loaded (the loaded corpus and the two
# JAX-trained loaded assets beside it)
LOADED_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "loaded_refs.json"
# every dictionary from training to the closed loop (phase DX): the JAX
# trainer's dictionary assets, each path's controller at its qp_iters and
# the JAX references, written by tests/test_torch_oracle.py
# --write-dictionaries
DICT_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "dictionary_refs.json"
# closed-loop steps before phase DX2's kernel checks
DX_CHECK_STEPS = 12
# DX4's depth of the jacfwd NMPC paths (nmpc-fs1, nmpc-bilin; 25 s and 76
# s at 301 steps on the H100): cut to keep the script inside its limit,
# to 101 when phase NU came, to 26 when phase GN came; their full-width
# gate is alive at the last step
DX_JACFWD_STEPS = 26
# the depth of phases S3 (the stage and chord routes at B=65536: 5.6 s
# and 10.8 s at 301 steps), R3 (iters2 and unblocked: 3.7 s and 4.5 s)
# and Q4 (the 'linear' route, 19.1 s): cut for the time limit when phase
# GN came; their gate is alive at full width
S3_STEPS = Q4_STEPS = 101
B_MAIN, B_GENERAL, B_CHECK, STEPS = 262144, 65536, 8192, 301
# H100 SXM published peaks: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


def log(*a):
    print(*a, flush=True)


def regime_configs(path=REGIME_REFS) -> dict:
    """name -> ``MpcConfig`` keyword arguments of every SQP regime in the
    reference file: its full JAX configuration restricted to the fields of
    the port's ``MpcConfig``, lists as tuples."""
    import dataclasses

    from koopman_realizations_torch.config import MpcConfig
    fields = {f.name for f in dataclasses.fields(MpcConfig)}
    refs = json.loads(Path(path).read_text())["regimes"]
    return {name: {k: tuple(v) if isinstance(v, list) else v
                   for k, v in entry["config"].items() if k in fields}
            for name, entry in refs.items()}


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


def phase_training(dev, drive, arm, ref, spread_X0, fused_rate, smi):
    """Phase T: the main path from the corpus to the closed loop.

    T1 trains the bilinear, linear and nonlinear models at the assets'
    recipe with ``Ksysid(..., device="cuda")``, twice: first with the
    caller's TF32 on, then off (the second run's stage times by CUDA
    events are the steady ones; both runs' one-step predictions must agree
    within 1e-6, as the trainer runs its f32 matmuls at full precision
    whatever the caller's setting, where TF32 moves the PCA projection by
    ~1e-3); T2 trains them with ``device="cpu"`` and holds
    card against CPU (full lift, PC subspace, one-step predictions); T3
    holds each card-trained model to its committed asset (NL, meta,
    scaler, one-step predictions within 1e-5); T4 saves and reloads each
    (arrays bitwise); T5 drives the fused bilinear and linear loops at
    B=262144 x 301 (alive 1.0) and the B=16 x 301 general runners of all
    three (err_mean within 1e-3 of the asset headers' JAX references).
    Any miss raises."""
    import numpy as np
    import torch

    from koopman_realizations_torch.config import MpcConfig, SysidConfig
    from koopman_realizations_torch.control.kmpc import (
        BilinearKmpc,
        LinearKmpc,
        NonlinearKmpc,
    )
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.edmd import STAGES, Ksysid
    from koopman_realizations_torch.ops.kernels._build import BUILD
    from koopman_realizations_torch.utils.checkpoint import (
        BENCH_MODEL,
        LINEAR_MODEL,
        NONLINEAR_MODEL,
        load_model,
        save_model,
    )
    from koopman_realizations_torch.utils.data import load_corpus
    from koopman_realizations_torch.utils.metrics import (
        lane_tracking_error,
        one_step_predictions,
        subspace_angle,
    )

    assets = {"bilinear": BENCH_MODEL, "linear": LINEAR_MODEL,
              "nonlinear": NONLINEAR_MODEL}
    ds = load_corpus()
    trained = {}
    for kind in ("bilinear", "linear", "nonlinear"):
        cfg = SysidConfig(model_type=kind, pca_explained=PCA_EXPLAINED[kind],
                          **TRAIN_RECIPE)
        # ---- T1: on the card, twice
        runs = []
        for caller in ("high", "highest"):          # TF32 on, then off
            torch.set_float32_matmul_precision(caller)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ks = Ksysid(ds, cfg, device=dev).train_models()
            val = ks.validate()
            torch.cuda.synchronize()
            runs.append((ks, val, time.perf_counter() - t0, ks.stage_ms()))
            if torch.get_float32_matmul_precision() != caller:
                raise AssertionError(f"T1 {kind}: the trainer left the "
                                     f"caller's matmul precision changed")
        ks, val, wall, ms = runs[1]
        lifted = ks.lift_snapshot_matrices()
        if not (all(t.device.type == "cuda" for t in lifted)
                and ks.full_lift().is_cuda):
            raise AssertionError(f"T1 {kind}: a training stage left the card")
        first = one_step_predictions(runs[0][0].model, ks.valdata, dev)
        card = one_step_predictions(ks.model, ks.valdata, dev)
        euclid = [float(v["error"]["euclid_mean"]) for v in val]
        log(f"T1 {kind} trained on the card: NL {ks.model.meta.NL} "
            f"(N_full {ks.basis.N_full}, {ks.snapshot_pairs.alpha.shape[0]} "
            f"pairs); stages (CUDA events, ms) " + ", ".join(
                f"{k} {ms.get(k, 0.0):.2f}" for k in STAGES)
            + f"; first run " + ", ".join(
                f"{k} {runs[0][3].get(k, 0.0):.2f}" for k in STAGES)
            + f"; wall {wall:.3f} s (first {runs[0][2]:.3f} s); validate "
            f"euclid_mean {', '.join(f'{e:.6f}' for e in euclid)} | {smi}")
        d_tf32 = np.abs(first - card).max()
        log(f"T1 {kind}: one-step predictions of the TF32-on and TF32-off "
            f"callers' trainings, max abs {d_tf32:.3e}")
        if not d_tf32 < 1e-6:
            raise AssertionError(f"T1 {kind}: the trainings with TF32 on "
                                 f"and off differ")
        # ---- T2: on the CPU, held against the card
        cpu = Ksysid(ds, cfg, device="cpu").train_models()
        fc, fh = ks.full_lift().cpu().double(), cpu.full_lift().double()
        lift_rel = ((fc - fh).abs() / fh.abs().clamp_min(1e-30)).max().item()
        same_k = ks.basis.pcs.shape == cpu.basis.pcs.shape
        angle = subspace_angle(ks.basis.pcs, cpu.basis.pcs) if same_k \
            else float("inf")
        d_cpu = np.abs(card - one_step_predictions(cpu.model, cpu.valdata,
                                                    "cpu")).max()
        log(f"T2 {kind} card vs CPU: full lift max rel {lift_rel:.3e}, PC "
            f"subspace largest angle {angle:.3e} rad (k {ks.basis.pcs.shape[1]}"
            f" / {cpu.basis.pcs.shape[1]}), one-step max abs {d_cpu:.3e}")
        if not (lift_rel <= 2.4e-7 and angle < 1e-6 and d_cpu < 1e-5):
            raise AssertionError(f"T2 {kind}: card and CPU trainings part")
        # ---- T3: against the committed asset
        am, asc, _ = load_model(assets[kind])
        scal_ok = all(np.allclose(getattr(ks.scaler, f), getattr(asc, f),
                                  rtol=1e-12, atol=0)
                      for f in ("y_factor", "y_offset", "u_factor",
                                "u_offset"))
        d_asset = np.abs(card - one_step_predictions(am, ks.valdata,
                                                     dev)).max()
        log(f"T3 {kind} card-trained vs asset {assets[kind].name}: NL "
            f"{ks.model.meta.NL} / {am.meta.NL}, meta equal "
            f"{ks.model.meta == am.meta}, scaler within 1e-12 {scal_ok}, "
            f"one-step max abs {d_asset:.3e}")
        if not (ks.model.meta == am.meta and scal_ok and d_asset < 1e-5):
            raise AssertionError(f"T3 {kind}: off the committed asset")
        # ---- T4: save and reload
        path = save_model(BUILD / "trained" / kind, ks.model, ks.scaler,
                          overwrite=True)
        lm, lsc, _ = load_model(path)
        names = [n for n in ("A", "B", "C", "M", "K", "W")
                 if getattr(ks.model, n, None) is not None]
        same = all(np.array_equal(getattr(lm, n), getattr(ks.model, n))
                   and getattr(lm, n).dtype == getattr(ks.model, n).dtype
                   for n in names) and np.array_equal(lm.basis.pcs,
                                                      ks.basis.pcs) \
            and all(np.array_equal(getattr(lsc, f), getattr(ks.scaler, f))
                    for f in ("y_factor", "y_offset", "u_factor",
                              "u_offset")) and lm.meta == ks.model.meta
        log(f"T4 {kind} save_model -> load_model: {', '.join(names)}, pcs, "
            f"scaler bitwise {same}")
        if not same:
            raise AssertionError(f"T4 {kind}: reloaded model differs")
        trained[kind] = ks
        del cpu

    # ---- T5: the closed loop with the card-trained models
    ctl = {"bilinear": (BilinearKmpc, MPC), "linear": (LinearKmpc, LINEAR_MPC),
           "nonlinear": (NonlinearKmpc, NMPC_MPC)}
    sims = {k: Ksim(arm, cls(trained[k].model, trained[k].scaler,
                             MpcConfig(**cfg), device=dev), device=dev)
            for k, (cls, cfg) in ctl.items()}
    XB, WB = spread_X0(B_MAIN), np.zeros((B_MAIN, 2), np.float32)
    for kind, name in (("bilinear", "step_fused"),
                       ("linear", "linear_step_fused")):
        run = sims[kind].fused_runner(ref, steps=STEPS)
        run(XB[:1024], WB[:1024])                   # warm-up (allocator)
        out, wall, _ = drive({name: STEPS - 1}, lambda: run(XB, WB))
        aliveB = out["alive"][:, -1].float().mean().item()
        eB = lane_tracking_error(out["Yp"], ref)
        rate = B_MAIN * (STEPS - 1) / wall
        log(f"T5 {name} on the card-trained {kind} model B={B_MAIN} steps="
            f"{STEPS}: {wall:.3f} s, {rate:.4e} lane-steps/s (phase 4/L4 on "
            f"the asset: {fused_rate[name]:.4e}), alive {aliveB:.6f}, "
            f"err_mean {eB.mean():.6f} | {smi}")
        if aliveB != 1.0 or not torch.isfinite(eB).all():
            raise AssertionError(f"T5 {name}: the fused loop lost lanes")
        del out
    W16 = np.zeros((16, 2), np.float32)
    for kind, name in (("bilinear", "bilin_lift"), ("linear", "ipm_shared"),
                       ("nonlinear", "nmpc_multipass")):
        jr = load_model(assets[kind])[2]["jax_reference"]
        o16, w16, _ = drive({name: STEPS - 1}, lambda: sims[kind]
                            .batched_runner(ref, steps=STEPS)(spread_X0(16),
                                                              W16))
        e16 = lane_tracking_error(o16["Yp"], ref)
        log(f"T5 {kind} general runner ({name}) on the card-trained model "
            f"B=16: alive {o16['alive'][:, -1].float().mean():.4f} err_mean "
            f"{e16.mean():.6f} err_worst {e16.max():.6f} (JAX general runner "
            f"on the asset {jr['err_mean']:.6f} / {jr['err_worst']:.6f}); "
            f"{w16:.1f} s")
        if not (bool(o16["alive"].all()) and torch.isfinite(o16["Yp"]).all()
                and abs(e16.mean().item() - jr["err_mean"]) < 1e-3):
            raise AssertionError(f"T5 {kind}: quality off the JAX reference")


def jax_lasso_candidates(basis, scaler) -> list:
    """The JAX trainer's lasso candidates (``LASSO_CANDIDATES``) as the
    port's ``BilinearModel``s in ``basis``: each model's lifted state
    re-signed to ``basis``'s PCA components (z' = S z, A' = S A S, each
    input block of B likewise), so they share its lift.  The file's
    scaler must be ``scaler`` (rtol 1e-12)."""
    import dataclasses

    import numpy as np

    from koopman_realizations_torch.models.koopman import from_jax_arrays

    data = np.load(LASSO_CANDIDATES)
    header = json.loads(str(data["header"]))
    shared = {k: data[k] for k in data.files
              if k != "header" and not k.startswith(("A_", "B_"))}
    out = []
    for i, lv in enumerate(header["lasso"]):
        m, sc = from_jax_arrays(dict(header, lasso=lv),
                                dict(shared, A=data[f"A_{i}"],
                                     B=data[f"B_{i}"]))
        if not all(np.allclose(getattr(sc, f), getattr(scaler, f),
                               rtol=1e-12, atol=0)
                   for f in ("y_factor", "y_offset", "u_factor",
                             "u_offset")):
            raise AssertionError("the JAX candidates' scaler is not the "
                                 "card training's")
        s = np.sign(np.sum(basis.pcs * m.basis.pcs, axis=0))
        S = np.concatenate([np.ones(basis.nzeta_aug), s, np.ones(1)]) \
            .astype(m.A.dtype)
        out.append(dataclasses.replace(
            m, A=S[:, None] * m.A * S[None],
            B=S[:, None, None] * m.B * S[None, None], basis=basis))
    return out


def phase_lasso_sweep(dev, drive, check_qp, kernel_ms, smi) -> dict:
    """Phase LS: a lasso sweep from the committed corpus to the closed
    loop.

    LS1 trains the bilinear asset recipe at ``LASSO_SWEEP``'s six lasso
    values on the card (FISTA in f64, the trainer's default cap and tol)
    and logs each candidate's iterations, FISTA time (CUDA events), final
    objective and free L1 norm against its budget (gate: within
    budget * (1 + 1e-12)).  LS2 fits the smallest budget to convergence
    on the card and on the CPU (gate: objectives within 1e-9 relative;
    max |dK| logged) and runs 2000 fixed iterations of lasso 8 on both
    (gate: objectives within 1e-5 relative, beside the CPU's own run on Px
    moved by one ulp).  LS3 runs ``lasso_sweep_closed_loop`` over 301
    blockM steps on twelve lanes: the six card-trained candidates and the
    JAX trainer's six behind the references (``jax_lasso_candidates``),
    one per-lane-P ``ipm_shared`` launch a step.  Gates, on every lane:
    the alive flag at the last step the JAX reference's (x64; where every
    JAX f32 run of the candidate keeps that flag); the card-trained
    unregularized candidate alive; where both are alive, err_mean within
    1e-3 of the JAX x64 value for a candidate that is ``f32_stable`` in
    the references (every JAX f32 run of it, as trained and with A moved
    by one ulp, within 1e-3 of x64), else within 1e-3 of the band of those
    runs (its loop amplifies f32 rounding, and the card runs f32).
    LS4 holds the kernel to its plain version and
    f64 on the sweep's own QPs (the lanes alive after their step) as phase
    Q2 does, and times it on one step's QPs.  Returns the sweep's
    ``ipm_shared`` launches, max |dx|, ms, plain ms and bound."""
    import numpy as np
    import torch

    from koopman_realizations_torch.config import (
        ArmConfig,
        MpcConfig,
        SysidConfig,
    )
    from koopman_realizations_torch.control.kmpc import BilinearKmpc
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.models.edmd import STAGES, Ksysid
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.ops.lasso import lasso_fista_f64
    from koopman_realizations_torch.utils.data import load_corpus
    from koopman_realizations_torch.utils.metrics import (
        one_step_predictions,
    )
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    from koopman_realizations_torch.workflows.lasso_sweep import (
        lasso_sweep_closed_loop,
    )

    r = LASSO_SWEEP
    refs = json.loads(LASSO_REFS.read_text())["candidates"]
    cfg = SysidConfig(model_type="bilinear",
                      pca_explained=PCA_EXPLAINED["bilinear"],
                      lasso=r["lasso"], lasso_iters=r["lasso_iters"],
                      lasso_tol=r["lasso_tol"], **TRAIN_RECIPE)
    # ---- LS1: the candidates, trained on the card
    ds = load_corpus()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ks, _, _ = drive({}, lambda: Ksysid(ds, cfg, device=dev).train_models())
    wall = time.perf_counter() - t0
    ms = ks.stage_ms()
    log(f"LS1 bilinear lasso candidates trained on the card: NL {ks.N}, "
        f"{ks.lift_snapshot_matrices()[0].shape[1]} regression columns; "
        f"stages (CUDA events, ms) " + ", ".join(
            f"{k} {ms.get(k, 0.0):.2f}" for k in STAGES)
        + f"; wall {wall:.3f} s | {smi}")
    for lv in r["lasso"]:
        if not np.isfinite(lv):
            continue
        st = ks.lasso_stats[lv]
        log(f"LS1 lasso {lv:g}: {st['iters']} FISTA iterations (cap "
            f"{r['lasso_iters']}, tol {r['lasso_tol']:g}), {st['ms']:.2f} ms "
            f"(CUDA events, {st['ms'] / st['iters'] * 1e3:.1f} us an "
            f"iteration), objective {st['objective']:.12e}, free L1 "
            f"{st['free_l1']:.12f} of budget {st['budget']:g}")
        if not st["free_l1"] <= st["budget"] * (1 + 1e-12):
            raise AssertionError(f"LS1 lasso {lv:g}: the L1 budget is "
                                 f"exceeded")
    # ---- LS2: the converged fit of the smallest budget on the card and
    # the CPU (1e-9), and 2000 fixed iterations of lasso 8 on both (1e-5:
    # that far short of convergence the objective on this Gram moves by
    # ~1e-6 relative under a one-ulp change of Px, and the CPU's own run on
    # Px so moved is logged beside the card's)
    Px, Py = ks.lift_snapshot_matrices()
    X, Y = Px.cpu().double(), Py.cpu().double()
    obj = lambda K: float(((X @ K.cpu() - Y) ** 2).sum())
    lv = min(v for v in r["lasso"] if np.isfinite(v))
    fit = lambda A, B: lasso_fista_f64(A, B, lv * ks.N,
                                       iters=r["lasso_iters"],
                                       tol=r["lasso_tol"])
    rc, rh = fit(Px, Py), fit(X, Y)
    oc, oh = obj(rc.K), obj(rh.K)
    rel = abs(oc - oh) / oh
    log(f"LS2 lasso {lv:g} converged: card {rc.iters} iterations, "
        f"objective {oc:.15e}; CPU {rh.iters} iterations, {oh:.15e}; "
        f"relative {rel:.3e}; max|dK| "
        f"{(rc.K.cpu() - rh.K).abs().max().item():.3e} (max |K| "
        f"{rh.K.abs().max().item():.3e}; not gated)")
    fixed = lambda A: obj(lasso_fista_f64(A, Y.to(A.device), 8.0 * ks.N,
                                          iters=2000).K)
    sign = torch.randint(0, 2, X.shape, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(0)) * 2 - 1
    k8c, k8h = fixed(Px), fixed(X)
    k8u = fixed(X * (1.0 + 2.0 ** -52 * sign))
    rel8 = abs(k8c - k8h) / k8h
    log(f"LS2 lasso 8, 2000 fixed iterations: objective card {k8c:.15e}, "
        f"CPU {k8h:.15e}, relative {rel8:.3e}; the CPU on Px moved by one "
        f"ulp relative {abs(k8u - k8h) / k8h:.3e}")
    if not (rel <= 1e-9 and rel8 <= 1e-5):
        raise AssertionError("LS2: card and CPU FISTA objectives part")
    # ---- LS3: every candidate a lane of one closed loop, the card's six
    # and the JAX trainer's six (the references' own models, re-signed to
    # the card's basis) in one batch of twelve
    steps = r["steps"]
    arm = Arm(ArmConfig(**r["arm"]), device=dev)
    mcfg = MpcConfig(**r["mpc"])
    jcands = jax_lasso_candidates(ks.basis, ks.scaler)
    C = len(ks.candidates)
    both = types.SimpleNamespace(candidates=ks.candidates + jcands,
                                 scaler=ks.scaler)
    rec = []             # each step's P, q, b, x0 and lanes alive after it
    hook = lambda qp, sol, alive: rec.append(
        (qp[0], qp[1], qp[3], qp[5], alive))
    out, wall, counts = drive(
        {"ipm_shared": steps - 1},
        lambda: lasso_sweep_closed_loop(both, arm, mcfg, blockM_reference(),
                                        steps=steps, device=dev,
                                        qp_hook=hook))
    err, alive = out["err"], out["alive"]
    ok = True
    for i, lv in enumerate(r["lasso"]):
        jr = refs[str(lv)]
        # the JAX f32 runs of the candidate (as trained and with A moved by
        # one ulp): where one parts from the x64 run by more than 1e-3, the
        # loop amplifies f32 rounding and is held to their band
        same_alive = all(a == jr["alive"] for a, _ in jr["f32_runs"])
        lo, hi = jr["f32_band"]
        if jr["f32_stable"]:
            near = lambda e: abs(e - jr["err_mean"]) < 1e-3
        else:
            near = lambda e: lo - 1e-3 < e < hi + 1e-3
        # the two trainings' models apart in scaled one-step prediction
        d = float(np.abs(one_step_predictions(ks.candidates[i], ks.valdata,
                                              dev)
                         - one_step_predictions(jcands[i], ks.valdata,
                                                dev)).max())
        lanes = ((i, "card-trained"), (C + i, "JAX-trained"))
        log(f"LS3 lasso {lv:g}: " + "; ".join(
            f"{who} alive {bool(alive[k, -1])} err_mean "
            f"{float(err[k].mean()):.6f} err_worst {float(err[k].max()):.6f}"
            for k, who in lanes)
            + f" (JAX x64 {jr['alive']} {jr['err_mean']:.6f} / "
              f"{jr['err_worst']:.6f}; JAX f32 runs {lo:.6f} to {hi:.6f}"
            + ("" if jr["f32_stable"] else ": the loop amplifies f32 "
               "rounding, err_mean held to that band +- 1e-3")
            + f"); one-step distance of the two trainings' models {d:.3e}")
        for k, who in lanes:
            ok &= (not same_alive) or bool(alive[k, -1]) == jr["alive"]
            if alive[k, -1] and jr["alive"]:
                ok &= near(float(err[k].mean()))
    log(f"LS3 sweep of {len(both.candidates)} candidates x {steps} steps: "
        f"{wall:.3f} s (CUDA events), {counts['ipm_shared']} ipm_shared "
        f"launches | {smi}")
    if not (ok and bool(alive[r["lasso"].index(float("inf")), -1])):
        raise AssertionError("LS3: the sweep is off the JAX reference")
    # ---- LS4: the kernel on the sweep's own QPs
    cons, cons64 = (BilinearKmpc(ks.candidates[0], ks.scaler, mcfg,
                                 device=dev, dtype=dt).constraints()
                    for dt in (torch.float32, torch.float64))

    def args(c, P, q, b, iters, x0):
        """ipm_shared's per-lane-P arguments as solve_qp_shared forms
        them: q scaled by iobj = 1 / max |P|, b by the row scale, the
        warm slack floor, cold duals."""
        iobj = 1.0 / P.abs().amax((0, 1)).clamp_min(1e-8)
        return (c, P.contiguous(), (q * iobj).contiguous(),
                (b / c.row[:, None]).contiguous(), x0.contiguous(), iters,
                1e-2, iobj.contiguous(), None)

    P, q, b, x0 = (torch.cat([st[i][..., st[4]] for st in rec], dim=-1)
                   for i in range(4))
    iters = mcfg.qp_iters
    a32 = args(cons, P, q, b, iters, x0)
    a64 = args(cons64, P.double(), q.double(), b.double(), iters,
               x0.double())
    dx = check_qp("ipm_shared (per-lane P)",
                  (IS.ipm_shared_cuda, IS.ipm_shared_plain), a32, a64, cons,
                  a32[3], f"(lasso sweep, n=27, mc=108) warm, "
                          f"{P.shape[-1]} live QPs of {len(rec)} steps")[0]
    mid = rec[len(rec) // 2]
    a6 = args(cons, *mid[:3], iters, mid[3])
    B = a6[1].shape[-1]
    n, mc = cons.n, cons.mc
    flops = (n * n + n + 4 * mc + mehrotra_ops(cons, iters, n * n)) * B
    k_ms = kernel_ms("ipm_shared", lambda: IS.ipm_shared_cuda(*a6), reps=20,
                     build=f"per-lane P n=27 at B={B}")
    p_ms = cuda_ms(lambda: IS.ipm_shared_plain(*a6), reps=3, warmup=1)
    b_ms, by = bound(flops, nbytes(*a6[1:5], a6[7]) + 4 * B * (n + 2 * mc)
                     + nbytes(cons.A, cons.Wd, cons.Wo))
    log(f"LS4 ipm_shared per-lane P at the sweep's B={B}: {k_ms:.4f} ms "
        f"(plain {p_ms:.2f} ms, bound {b_ms:.5f} ms by {by}); "
        f"{counts['ipm_shared']} launches x {k_ms:.4f} ms are "
        f"{100 * counts['ipm_shared'] * k_ms / 1e3 / wall:.1f} % of the "
        f"sweep's {wall:.3f} s; the rest is the lift, the per-lane "
        f"assembly and Gram, the plain plant and glue | {smi}")
    return {"launches": counts["ipm_shared"], "err": dx, "ms": k_ms,
            "plain": p_ms, "bound": b_ms, "by": by}


def loaded_lanes(B: int, r: dict):
    """The loaded experiment's lanes (X0 (B, 4), W (B, 2)), f32, for the
    recipe ``r`` of ``LOADED_REFS`` (tests/test_torch_oracle.py:
    loaded_lanes): the first ``B_ref`` lanes the references' (the first
    joint from linspace(-spread, spread, B_ref)), the rest from
    linspace(-spread, spread, B - B_ref); lane i carries grid[i % 3]."""
    import numpy as np
    X0 = np.zeros((B, 4))
    nref = min(B, r["B_ref"])
    X0[:nref, 0] = np.linspace(-r["spread"], r["spread"], r["B_ref"])[:nref]
    if B > nref:
        X0[nref:, 0] = np.linspace(-r["spread"], r["spread"], B - nref)
    W = np.asarray(r["grid"], np.float64)[np.arange(B) % len(r["grid"])]
    return X0.astype(np.float32), W.astype(np.float32)


def loaded_lane_gate(e, jr: dict):
    """Gate 2 of a loaded loop, lane by lane: how far each reference lane's
    err_mean (the first ``len(jr["err_mean"])`` of ``e``) lies outside the
    hull of its JAX x64 value and its band of JAX's own f32 runs (the
    asset and its one-ulp copies, ``jr["f32"]["band"]``); 0 inside.  A
    lane passes below 1e-3."""
    import numpy as np
    x64 = np.asarray(jr["err_mean"])
    band = np.asarray(jr["f32"]["band"])
    lo, hi = np.minimum(x64, band[:, 0]), np.maximum(x64, band[:, 1])
    e = np.asarray(e)[:len(x64)]
    return np.maximum(np.maximum(lo - e, e - hi), 0.0)


def one_ulp_floor(ks, asset) -> float:
    """The most a one-ulp change (three seeded draws of directions) of the
    f32 extraction matrix L = Px A^T + u B^T moves the linear ``asset``'s
    own extraction (M by the minimum-norm solve of ``Ksysid.get_model``,
    rcond f32 eps) in scaled one-step prediction on ``ks.valdata``; host
    numpy, ``ks`` a loaded linear ``Ksysid`` on the asset's corpus."""
    import dataclasses

    import numpy as np

    from koopman_realizations_torch.utils.metrics import (
        one_step_predictions,
    )
    NL = ks.NL
    Px, Py = (t[:, :NL].double().cpu().numpy()
              for t in ks.lift_snapshot_matrices())
    K = np.asarray(asset.K, np.float32)
    A, B = K.T[:NL, :NL], K.T[:NL, NL:]
    L = (Px.astype(np.float32) @ A.T
         + ks.snapshot_pairs.u.astype(np.float32) @ B.T)

    def preds(Lf):
        Mt = np.linalg.lstsq(Lf.astype(np.float64), Py,
                             rcond=float(np.finfo(np.float32).eps))[0]
        M = Mt.T.astype(np.float32)
        return one_step_predictions(dataclasses.replace(
            asset, A=M @ A, B=M @ B), ks.valdata, ks.device)
    p0 = preds(L)
    rng = np.random.default_rng(0)
    far = 0.0
    for _ in range(3):
        up = rng.random(L.shape) < 0.5
        Lu = np.nextafter(L, np.where(up, np.inf, -np.inf).astype(np.float32))
        far = max(far, float(np.abs(preds(Lu) - p0).max()))
    return far


def lift_ulp_floor(ks, draws: int = 3) -> float:
    """The most that moving every entry of the f32 regression input Px
    one ulp (``draws`` seeded draws of directions) moves ``ks``'s own
    model in scaled one-step prediction on ``ks.valdata``: the fit's
    sensitivity to the last bit of the lift, which two trainings whose f32
    lifts sum in different orders (a PCA projection on another device or
    library) differ by.  ``ks`` a trained ``Ksysid``; host numpy."""
    import numpy as np
    import torch

    from koopman_realizations_torch.utils.metrics import (
        one_step_predictions,
    )
    extract = {"linear": ks.get_model, "bilinear": ks.get_BLmodel,
               "nonlinear": ks.get_NLmodel}[ks.cfg.model_type]
    Px, Py = ks.lift_snapshot_matrices()
    p0 = one_step_predictions(ks.model, ks.valdata, ks.device)
    X = Px.cpu().numpy()
    rng = np.random.default_rng(0)
    far = 0.0
    saved = ks._lifted
    try:
        for _ in range(draws):
            up = rng.random(X.shape) < 0.5
            Xu = torch.as_tensor(np.nextafter(X, np.where(
                up, np.inf, -np.inf).astype(X.dtype)), device=Px.device)
            ks._lifted = (Xu, Py)
            m = extract(ks._koop(ks._lstsq(Xu, Py)))
            far = max(far, float(np.abs(one_step_predictions(
                m, ks.valdata, ks.device) - p0).max()))
    finally:
        ks._lifted = saved
    return far


def loaded_setup(dev):
    """The loaded experiment's references, controllers (f32 and f64),
    observers, plant and reference, and the specs of its four new builds:
    ``bilin`` at NL=42 / m=2, ``ipm_shared``'s lane-shared build at the
    loaded linear QP and its per-lane-P builds of the two observers (n=2
    bilinear, n=1 linear)."""
    import torch

    from koopman_realizations_torch.config import ArmConfig, MpcConfig
    from koopman_realizations_torch.control.kmpc import (
        BilinearKmpc,
        LinearKmpc,
    )
    from koopman_realizations_torch.control.observer import (
        make_load_observer,
    )
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.ops.kernels import bilin as BI
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.utils.checkpoint import (
        LOADED_BILINEAR_MODEL,
        LOADED_LINEAR_MODEL,
        load_model,
    )
    from koopman_realizations_torch.utils.trajectories import (
        circle_reference,
    )
    refs = json.loads(LOADED_REFS.read_text())
    cfg = MpcConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in refs["mpc"].items()})
    L = types.SimpleNamespace(refs=refs, r=refs["recipe"], cfg=cfg,
                              ref=circle_reference(), ctl={}, ctl64={},
                              obs={}, obs64={}, models={})
    for kind, path, cls in (("bilinear", LOADED_BILINEAR_MODEL, BilinearKmpc),
                            ("linear", LOADED_LINEAR_MODEL, LinearKmpc)):
        model, scaler, _ = load_model(path)
        L.models[kind] = (model, scaler, path)
        for dt, ctl, obs in ((torch.float32, L.ctl, L.obs),
                             (torch.float64, L.ctl64, L.obs64)):
            ctl[kind] = cls(model, scaler, cfg, device=dev, dtype=dt)
            obs[kind] = make_load_observer(model, cfg, device=dev, dtype=dt)
    L.arm = Arm(ArmConfig(**L.r["arm"]), device=dev)
    L.specs = {"bilin": BI.kernel_spec(L.ctl["bilinear"].bilin_qp()),
               "ipm_shared": IS.kernel_spec(L.ctl["linear"].constraints()),
               "observer n=2": IS.kernel_spec(L.obs["bilinear"].cons_box,
                                              lane_p=True),
               "observer n=1": IS.kernel_spec(L.obs["linear"].cons_box,
                                              lane_p=True)}
    return L


def plant_lanes(arm, B: int):
    """Seeded lanes (X (nx, B), U (Nmods, B), W (2, B)) f32 on the arm's
    device in the closed loops' range: the first joint spread over
    +-0.2 rad, the other angles and the rates within +-0.05, inputs
    within +-0.5, loads of the loaded grid's range."""
    import torch
    g = torch.Generator().manual_seed(0)
    X = 0.1 * (torch.rand((arm.cfg.nx, B), generator=g) - 0.5)
    X[0] = torch.linspace(-0.2, 0.2, B)
    U = torch.rand((arm.cfg.Nmods, B), generator=g) - 0.5
    W = torch.rand((2, B), generator=g) * torch.tensor([[0.9], [1.2]]) \
        - torch.tensor([[0.0], [0.6]])
    return tuple(t.to(arm.G.device) for t in (X, U, W))


def loaded_state(L, kind: str, X0, W, k_end: int):
    """The loaded experiment's lanes (X0, W) after ``k_end`` closed-loop
    steps of the general runner's arithmetic on ``L``'s f32 controller of
    ``kind`` (the observer before the lift; no lane frozen): the scaled
    outputs and their window, the previous input and its window, the plan,
    the load estimate and the next step's reference window."""
    import torch

    from koopman_realizations_torch.control.ksim import Ksim
    mpc, obs = L.ctl[kind], L.obs[kind]
    sc, dev, B = mpc.scaler, mpc.device, X0.shape[0]
    wins = Ksim(L.arm, mpc, device=dev).reference_windows(L.ref, k_end + 2)
    x = torch.as_tensor(X0, device=dev).T.contiguous()
    Wt = torch.as_tensor(W, device=dev).T.contiguous()
    ysc = sc.y_down(L.arm.get_y(x), axis=0)
    upsc = sc.u_down(x.new_zeros((mpc.m, B)), axis=0)
    ywin = ysc[None].repeat(obs.horizon + 1, 1, 1)
    uwin = upsc[None].repeat(obs.horizon + 1, 1, 1)
    U, what = upsc.repeat(mpc.Np, 1), x.new_zeros((2, B))
    for k in range(k_end):
        what = obs(k + 1, ywin, uwin, what)
        U, _ = mpc.solve(mpc.lift(ysc, what), upsc, wins[k], U)
        x = L.arm.step(x, sc.u_up(upsc, axis=0), Wt)
        ysc = sc.y_down(L.arm.get_y(x), axis=0)
        upsc = U[mpc.m:2 * mpc.m].contiguous()
        ywin = torch.cat([ywin[1:], ysc[None]])
        uwin = torch.cat([uwin[1:], upsc[None]])
    return types.SimpleNamespace(ysc=ysc, upsc=upsc, U=U, what=what,
                                 ywin=ywin, uwin=uwin, win=wins[k_end])


def loaded_bilin_args(L, st) -> dict:
    """{dtype: ``bilin_cuda`` / ``bilin_plain`` arguments} of the loaded
    bilinear controller's QP at the lanes of ``st`` (``loaded_state``), in
    f32 and f64: the lifted state of the load estimate, the shifted plan,
    cold duals (the controller's)."""
    import torch
    out = {}
    for dt, m in ((torch.float32, L.ctl["bilinear"]),
                  (torch.float64, L.ctl64["bilinear"])):
        out[dt] = (m.bilin_qp(),
                   m.lift(st.ysc.to(dt), st.what.to(dt)).contiguous(),
                   st.upsc.to(dt).contiguous(),
                   m.warm_start(st.U.to(dt)).contiguous(), None,
                   st.win.to(dt).contiguous(), m.cfg.qp_iters, 1e-2)
    return out


def loaded_observer_args(obs32, obs64, st) -> dict:
    """{dtype: ``ipm_shared`` per-lane-P arguments} of an observer's box
    QP (``LoadObserver.qp``) at the windows of ``st``, as
    ``solve_qp_shared`` forms them: iobj = 1 / max |P|, q by it, b by the
    row scale, the cold start (x0 = 0, slack floor 1, lam = 1)."""
    import torch
    out = {}
    for dt, o in ((torch.float32, obs32), (torch.float64, obs64)):
        P, q, cons, b, iters = o.qp(st.ywin.to(dt), st.uwin.to(dt),
                                    st.what.to(dt))
        iobj = 1.0 / P.abs().amax((0, 1)).clamp_min(1e-8)
        out[dt] = (cons, P, (q * iobj).contiguous(),
                   (b / cons.row[:, None]).contiguous(), torch.zeros_like(q),
                   iters, 1.0, iobj.contiguous(), None)
    return out


def loaded_linear_args(L, st) -> dict:
    """{dtype: ``ipm_shared`` lane-shared arguments} of the loaded linear
    controller's QP at the lanes of ``st`` (``LinearKmpc.qp_args``: the
    lane-shared P22 / obj, q and b per lane, the shifted plan, cold)."""
    import torch
    out = {}
    for dt, mm in ((torch.float32, L.ctl["linear"]),
                   (torch.float64, L.ctl64["linear"])):
        z = mm.lift(st.ysc.to(dt), st.what.to(dt))
        out[dt] = mm.qp_args(z, st.upsc.to(dt), st.win.to(dt),
                             st.U.to(dt))[0]
    return out


def phase_loaded(dev, drive, check_qp, ptx, L, smi) -> dict:
    """Phase LD: the paper's loaded-arm experiment (BASELINE.md row 5) on
    the card, from the committed loaded corpus to the closed loop with the
    load observer on the circle.

    LD1 trains the loaded bilinear and linear models (poly-2, PCA, nw=2:
    NL=42) on the card and on the CPU and holds the card's to the CPU's
    and to the JAX-trained assets in scaled one-step prediction (1.2e-7;
    the linear model within twice its extraction's one-ulp floor where
    that is more, ``one_ulp_floor``).  LD2 holds the four new builds to
    their plain versions and f64 (``check_qp``) on the lanes of the
    experiment after 14 closed-loop steps (the observer has updated at
    k=12, 14): ``bilin`` (NL=42, m=2, n=8, mc=32), ``ipm_shared``'s
    lane-shared build at the loaded linear QP and its per-lane-P builds of
    the observers' box QPs (n=2, n=1), and times each at B=2048 beside its
    bound and plain version.  LD3 runs the loops at B=2048 x 301 steps on
    the JAX-trained assets (bilinear with and without the observer, linear
    with it), the first 16 lanes the references': on each of them alive
    as JAX x64's and err_mean within 1e-3 of the hull of x64's and the
    band of JAX's own f32 runs (``loaded_lane_gate``),
    the whole batch with the observer at JAX f32's alive fraction and
    within 1e-3 of its err_mean, What in [-1, 1], the linear observer's
    last component exactly 0, the bilinear loop's mean err on the 16 lanes
    with the observer below 0.8x without; each run's kernels by
    ``torch.profiler`` over 20 steps.  Returns each build's launches,
    error, times and bound for the kernels line."""
    import numpy as np
    import torch

    from koopman_realizations_torch.config import SysidConfig
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.edmd import STAGES, Ksysid
    from koopman_realizations_torch.ops.kernels import bilin as BI
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.utils.data import (
        LOADED_CORPUS,
        load_corpus,
    )
    from koopman_realizations_torch.utils.metrics import (
        lane_tracking_error,
        one_step_predictions,
    )

    refs, r = L.refs, L.r
    sysid = {k: tuple(v) if isinstance(v, list) else v
             for k, v in refs["sysid"].items()}
    # ---- LD1: loaded training on the card, against the CPU and the assets
    ds = load_corpus(LOADED_CORPUS)
    for kind in ("bilinear", "linear"):
        cfg = SysidConfig(model_type=kind, **sysid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks, _, _ = drive({}, lambda: Ksysid(ds, cfg, device=dev)
                         .train_models())
        wall = time.perf_counter() - t0
        cpu = Ksysid(ds, cfg, device="cpu").train_models()
        asset = L.models[kind][0]
        osp = lambda m: one_step_predictions(m, ks.valdata, dev)
        d_cpu = float(np.abs(osp(ks.model) - osp(cpu.model)).max())
        d_asset = float(np.abs(osp(ks.model) - osp(asset)).max())
        floor = one_ulp_floor(cpu, asset) if kind == "linear" else 0.0
        lim = max(1.2e-7, 2.0 * floor)
        ms = ks.stage_ms()
        log(f"LD1 loaded {kind} trained on the card: N {ks.N}, NL {ks.NL}, "
            f"nw {ks.nw}; stages (CUDA events, ms) " + ", ".join(
                f"{k} {ms.get(k, 0.0):.2f}" for k in STAGES)
            + f"; wall {wall:.3f} s; one-step distance to the CPU's "
              f"training {d_cpu:.3e}, to the JAX-trained asset "
              f"{d_asset:.3e} (bound {lim:.3e}"
            + (f": twice the extraction's one-ulp floor {floor:.3e}"
               if lim > 1.2e-7 else "") + f") | {smi}")
        if not (ks.NL == 42 and d_asset <= lim and d_cpu <= lim):
            raise AssertionError(f"LD1 {kind}: the card's loaded training "
                                 f"is off the asset")
        del ks, cpu

    # ---- LD2: the new builds against their plain versions and f64
    B, steps = r["B_full"], r["steps"]
    X0, W = loaded_lanes(B, r)

    out = {}
    k_end = 14
    # bilin at NL=42 from the lifted state of the load estimate
    st = {kind: loaded_state(L, kind, X0, W, k_end)
          for kind in ("bilinear", "linear")}
    a = loaded_bilin_args(L, st["bilinear"])
    m = L.ctl["bilinear"]
    bq = a[torch.float32][0]
    err, _ = check_qp("bilin", (BI.bilin_cuda, BI.bilin_plain),
                      a[torch.float32], a[torch.float64], m.constraints(),
                      m.cFr[:, None] - m.F0r @ a[torch.float32][2],
                      f"(loaded, NL={bq.nzl}, m={bq.m}, n={bq.n}, "
                      f"mc={bq.mc}) cold B={B} after {k_end} steps")
    flops = qp_ops(bq, m.cfg.qp_iters) * B
    z, up, x0, sq = (a[torch.float32][i] for i in (1, 2, 3, 5))
    b_ms, b_by = bound(flops, nbytes(z, up, x0, sq)
                       + 4 * B * (bq.n + 2 * bq.mc + 1)
                       + nbytes(bq.gens, bq.rdiag, bq.A, bq.cFr, bq.F0r,
                                bq.Wd, bq.Wo))
    out["bilin"] = {
        "err": err, "ms": cuda_ms(lambda: BI.bilin_cuda(*a[torch.float32]),
                                  reps=20),
        "plain": cuda_ms(lambda: BI.bilin_plain(*a[torch.float32]), reps=3,
                         warmup=1), "bound": b_ms, "by": b_by}
    log(f"LD2 bilin loaded NL=42 at B={B}: {out['bilin']['ms']:.4f} ms "
        f"(plain {out['bilin']['plain']:.2f} ms, bound {b_ms:.5f} ms by "
        f"{b_by}, {flops / B:.0f} op/lane); ptxas: {ptx(L.specs['bilin'])} "
        f"| {smi}")
    # the observers' box QPs (n=2 bilinear, n=1 linear) at the same lanes
    for kind, name in (("bilinear", "observer n=2"),
                       ("linear", "observer n=1")):
        aa = loaded_observer_args(L.obs[kind], L.obs64[kind], st[kind])
        f32 = aa[torch.float32]
        cons = f32[0]
        e, _ = check_qp("ipm_shared (per-lane P)",
                        (IS.ipm_shared_cuda, IS.ipm_shared_plain),
                        f32, aa[torch.float64], cons, f32[3],
                        f"({name}, n={cons.n}, mc={cons.mc}) cold B={B}")
        n_, mc_ = cons.n, cons.mc
        flops = (n_ * n_ + n_ + mehrotra_ops(cons, f32[5], n_ * n_)) * B
        b_ms, b_by = bound(flops, nbytes(*f32[1:5], f32[7])
                           + 4 * B * (n_ + 2 * mc_)
                           + nbytes(cons.A, cons.Wd, cons.Wo))
        out[name] = {
            "err": e, "ms": cuda_ms(lambda: IS.ipm_shared_cuda(*f32),
                                    reps=20),
            "plain": cuda_ms(lambda: IS.ipm_shared_plain(*f32), reps=3,
                             warmup=1), "bound": b_ms, "by": b_by}
        log(f"LD2 ipm_shared {name} (per-lane P, the load observer's box "
            f"QP) at B={B}: {out[name]['ms']:.4f} ms (plain "
            f"{out[name]['plain']:.2f} ms, bound {b_ms:.6f} ms by {b_by}); "
            f"ptxas: {ptx(L.specs[name])} | {smi}")
    # ipm_shared's lane-shared build at the loaded linear QP
    aa = loaded_linear_args(L, st["linear"])
    f32 = aa[torch.float32]
    cons = f32[0]
    e, _ = check_qp("ipm_shared (lane-shared)",
                    (IS.ipm_shared_cuda, IS.ipm_shared_plain),
                    f32, aa[torch.float64], cons, f32[3],
                    f"(loaded linear, n={cons.n}, mc={cons.mc}) B={B} after "
                    f"{k_end} steps")
    flops = mehrotra_ops(cons, f32[5], nnz(f32[1])) * B
    b_ms, b_by = bound(flops, nbytes(*f32[2:5]) + 4 * B * (cons.n
                                                          + 2 * cons.mc)
                       + nbytes(f32[1], cons.A, cons.Wd, cons.Wo))
    out["ipm_shared"] = {
        "err": e, "ms": cuda_ms(lambda: IS.ipm_shared_cuda(*f32), reps=20),
        "plain": cuda_ms(lambda: IS.ipm_shared_plain(*f32), reps=3,
                         warmup=1), "bound": b_ms, "by": b_by}
    log(f"LD2 ipm_shared lane-shared at the loaded linear QP (n={cons.n}, "
        f"mc={cons.mc}) at B={B}: {out['ipm_shared']['ms']:.4f} ms (plain "
        f"{out['ipm_shared']['plain']:.2f} ms, bound {b_ms:.6f} ms by "
        f"{b_by}); ptxas: {ptx(L.specs['ipm_shared'])} | {smi}")
    del st, a, aa

    # ---- LD3: the loops at B=2048 x 301 steps on the JAX-trained assets
    runs = (("bilinear", True), ("bilinear", False), ("linear", True))
    csrc = ROOT / "koopman_realizations_torch" / "csrc"
    names = kernel_names(csrc)
    of = {src: set(KERNEL_DEF.findall((csrc / f"{src}.cu").read_text()))
          for src in ("bilin", "ipm_shared")}
    err16, launches = {}, {"bilin": 0, "ipm_shared": {}}
    per_call = {}
    for kind, use_obs in runs:
        obs = L.obs[kind] if use_obs else None
        sim = Ksim(L.arm, L.ctl[kind], observer=obs, device=dev)
        run = sim.batched_runner(L.ref, steps=steps)
        sim.batched_runner(L.ref, steps=3)(X0, W)        # warm-up, capture
        updates = sum(obs.updates(k) for k in range(1, steps)) if obs else 0
        expected = {"bilin": steps - 1, "ipm_shared": updates} \
            if kind == "bilinear" else {"ipm_shared": steps - 1 + updates}
        expected = {k: v for k, v in expected.items() if v}
        res, wall, counts = drive(expected, lambda: run(X0, W))
        key = f"{kind}/{use_obs}"
        jr = refs["runs"][key]
        e = lane_tracking_error(res["Yp"], L.ref).cpu().numpy()
        alive = res["alive"][:, -1].cpu().numpy()
        What = res["what"].cpu().numpy()
        x64 = np.asarray(jr["err_mean"])
        f32 = np.asarray(jr["f32"]["err_mean"])
        band = np.asarray(jr["f32"]["band"])
        nref = len(x64)
        d64 = np.abs(e[:nref] - x64)
        # gate 2, each reference lane: within 1e-3 of the hull of its x64
        # err_mean and its band of JAX's own f32 runs (the asset and
        # one-ulp copies of its A: the loop amplifies f32 rounding)
        off = loaded_lane_gate(e, jr)
        near = bool((off < 1e-3).all())
        e16, i = float(e[:nref].mean()), int(d64.argmax())
        err16[key] = e16
        log(f"LD3 loaded {kind} {'with' if use_obs else 'without'} the "
            f"observer, B={B} x {steps} steps: {wall:.3f} s (CUDA events), "
            f"{B * (steps - 1) / wall:.4e} lane-steps/s, alive "
            f"{alive.mean():.6f}, err_mean {e.mean():.6f}, err_worst "
            f"{e.max():.6f}, max |What| {np.abs(What).max():.6f}, launches "
            f"{ {k: v for k, v in counts.items() if v} }; the {nref} "
            f"reference lanes: err_mean {e16:.6f} (JAX x64 "
            f"{x64.mean():.6f}, JAX f32 {f32.mean():.6f}), a lane's |d| "
            f"to x64 at most {d64[i]:.3e} (lane {i}: {e[i]:.6f}, x64 "
            f"{x64[i]:.6f}, JAX f32 band {band[i, 0]:.6f} to "
            f"{band[i, 1]:.6f}), outside its hull of x64 and "
            f"the band by at most {off.max():.3e} (lane "
            f"{int(off.argmax())}; bound 1e-3), alive "
            f"{int(alive[:nref].sum())}/{nref} (JAX x64 "
            f"{sum(jr['alive'])}) | {smi}")
        ok = bool((alive[:nref] == np.asarray(jr["alive"])).all()
                  and near and np.abs(What).max() <= 1.0 + 1e-6
                  and np.isfinite(e).all())
        if kind == "linear":
            ok &= bool((What[..., -1] == 0).all())
        if key == refs["f32_full"]["run"]:
            full = refs["f32_full"]
            ok &= bool(alive.mean() >= full["alive"]
                       and abs(e.mean() - full["err_mean"]) < 1e-3)
            log(f"LD3 {key} B={B}: alive {alive.mean():.6f} err_mean "
                f"{e.mean():.6f} against JAX's own f32 run at B="
                f"{full['B']}: alive {full['alive']:.6f} err_mean "
                f"{full['err_mean']:.6f}")
        if not ok:
            raise AssertionError(f"LD3 {key}: off the JAX reference")
        launches["bilin"] += counts.get("bilin", 0)
        launches["ipm_shared"][key] = counts.get("ipm_shared", 0)
        short = sim.batched_runner(L.ref, steps=21)
        ev = device_events(lambda: short(X0, W), 1)
        log(f"LD3 {key} kernels over 20 steps (torch.profiler): " + (
            "; ".join(f"{k} {ms:.4f} ms x {n:g} = {ms / n:.4f} ms a launch"
                      for k, (ms, n) in sorted(ev.items()) if k in names)
            if ev else "no device time from the profiler") + f" | {smi}")
        # device launches a wrapper call on the path: the profiler's
        # launches of each source's kernels over these 20 steps' calls
        upd20 = sum(obs.updates(k) for k in range(1, 21)) if obs else 0
        calls = {"bilin": 20 if kind == "bilinear" else 0,
                 "ipm_shared": upd20 + (20 if kind == "linear" else 0)}
        for src, c in calls.items():
            if c and ev:
                per_call[src if src == "bilin" else key] = sum(
                    n for k, (_, n) in ev.items() if k in of[src]) / c
        del res
    ratio = err16["bilinear/True"] / err16["bilinear/False"]
    log(f"LD3 the observer on the bilinear loop, {len(x64)} reference "
        f"lanes: err_mean {err16['bilinear/True']:.6f} with, "
        f"{err16['bilinear/False']:.6f} without (ratio {ratio:.3f}; "
        f"tests/test_loaded.py:106 asks < 0.8)")
    if not ratio < 0.8:
        raise AssertionError("LD3: the observer does not improve tracking")
    L.arm.clear_graphs()
    out["launches"] = launches
    out["per_call"] = per_call
    return out


def dict_config(entry: dict):
    """The MpcConfig of a ``DICT_REFS`` path: its knobs at its qp_iters."""
    from koopman_realizations_torch.config import MpcConfig
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in entry["knobs"].items()}
    return MpcConfig(**dict(kw, qp_iters=entry["qp_iters"]))


def dict_setup(dev, arm):
    """Phase DX's references, models, controllers (f32 and f64), plants
    and the specs of its builds, by path of ``DICT_REFS``: ``bilin_lift``
    at the delayed model's nz=15 and degree 2, ``bilin`` at NL=84 (poly-3
    without PCA) and NL=19 (fourier_sparser 1), ``nmpc_pass`` of the
    jacfwd route (the pass kernel without F's tables) and the existing
    ``ipm_factored`` n=27 and ``ipm_shared`` n=12 builds."""
    import torch

    from koopman_realizations_torch.control.kmpc import make_kmpc
    from koopman_realizations_torch.control.ksim import KoopmanPlant, Ksim
    from koopman_realizations_torch.ops.kernels import bilin as BI
    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    from koopman_realizations_torch.ops.kernels import ipm_factored as IF
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
    from koopman_realizations_torch.utils.checkpoint import load_model
    refs = json.loads(DICT_REFS.read_text())
    D = types.SimpleNamespace(refs=refs, paths={}, specs={})
    assets = DICT_REFS.parent
    for name, r in refs["paths"].items():
        model, scaler, _ = load_model(assets / r["asset"])
        cfg = dict_config(r)
        P = types.SimpleNamespace(
            r=r, model=model, scaler=scaler, cfg=cfg,
            mpc=make_kmpc(model, scaler, cfg, device=dev),
            mpc64=make_kmpc(model, scaler, cfg, device=dev,
                            dtype=torch.float64))
        P.plant = KoopmanPlant(model, scaler, dev) if r["plant"] == "model" \
            else arm
        P.sim = Ksim(P.plant, P.mpc, device=dev)
        P.sim64 = Ksim(P.plant, P.mpc64, device=dev)
        m = P.mpc
        if getattr(m, "route", None) == "jacfwd":
            P.kernel, spec = "nmpc_pass", NP.kernel_spec(m.nmpc_qp())
        elif getattr(m, "lift_fused", False):
            P.kernel, spec = "bilin_lift", BL.kernel_spec(m.lift_qp())
        elif hasattr(m, "bilin_qp") and m.blocked:
            P.kernel, spec = "bilin", BI.kernel_spec(m.bilin_qp())
        elif hasattr(m, "bilin_qp"):
            P.kernel, spec = "ipm_factored", IF.kernel_spec(m.constraints(),
                                                            m.p)
        else:
            P.kernel, spec = "ipm_shared", IS.kernel_spec(m.constraints())
        P.spec = spec
        D.specs[name] = spec
        D.paths[name] = P
    return D


def dict_lanes(P, B: int):
    """A DX path's lanes (X0, W): the bench's arm states (the first joint
    spread over +-0.2 rad), or the lifted 0.15 randn zetas of the model in
    the loop (``np.random.default_rng(0)``, tests/test_torch_oracle.py:
    dict_zetas; the first 16 rows are the references')."""
    import numpy as np
    import torch
    W = np.zeros((B, 2), np.float32)
    if P.r["plant"] != "model":
        X0 = np.zeros((B, 6), np.float32)
        X0[:, 0] = np.linspace(-0.2, 0.2, B)
        return X0, W
    z = (0.15 * np.random.default_rng(0).standard_normal(
        (B, P.model.meta.nzeta))).astype(np.float32)
    zt = torch.as_tensor(z, device=P.mpc.device).T
    return P.model.basis.lift(zt).T.contiguous(), W


def dict_alive_gate(alive, r: dict) -> bool:
    """Whether the 16 reference lanes' alive flags of a DX loop are JAX's:
    each lane alive as in JAX's x64 run, or as in one of JAX's own f32
    runs of it (the asset and its one-ulp copies, ``alive_copies`` of
    ``copies`` keeping the lane alive)."""
    import numpy as np
    f32 = r["f32"]
    n = f32.get("copies", 1)
    kept = np.asarray(f32.get("alive_copies",
                              [n * int(a) for a in f32["alive"]]))
    a, x64 = np.asarray(alive, bool), np.asarray(r["alive"], bool)
    return bool(((a == x64) | (a & (kept > 0)) | (~a & (kept < n))).all())


# a DX loop may have this many of its 16 reference lanes outside the hull
# of x64 and JAX's f32 band, each on a lane where that band is wider
# than CHAOTIC_BAND, and by less than the band's width: the card's f32 run
# is one more sample of JAX's f32 spread, which falls outside the range
# of 96 samples with probability 2/97 a lane (3 or more of 16: 0.4 %)
CHAOTIC_LANES, CHAOTIC_BAND = 2, 1e-2


def dict_lane_gate(e, r: dict):
    """Gate 2 of a DX loop, lane by lane: (ok, off, loose) with ``off``
    each reference lane's distance outside the hull of its JAX x64
    err_mean and its band of JAX's own f32 runs (``loaded_lane_gate``)
    and ``loose`` the lanes off by 1e-3 or more.  ok where every lane is
    within 1e-3, but at most ``CHAOTIC_LANES`` lanes whose band is wider
    than ``CHAOTIC_BAND`` (one ulp of A moves them by ten times the gate
    or more), each off by less than its band's width."""
    import numpy as np
    off = loaded_lane_gate(e, r)
    band = np.asarray(r["f32"]["band"])
    width = band[:, 1] - band[:, 0]
    loose = np.nonzero(off >= 1e-3)[0]
    ok = len(loose) <= CHAOTIC_LANES and bool(
        ((width[loose] > CHAOTIC_BAND) & (off[loose] < width[loose])).all())
    return ok, off, loose


def dict_all_alive(r: dict) -> bool:
    """The refs keep all 16 lanes alive: JAX's x64 run and every one of
    JAX's own f32 runs."""
    return all(r["alive"]) and r["f32"]["all_alive"]


def dict_launches(P, steps: int) -> dict:
    """A DX path's kernel launches in a ``steps``-step run: one QP a step
    (the SQP: one ``nmpc_pass`` a pass)."""
    n = steps - 1
    if P.kernel == "nmpc_pass":
        n *= P.cfg.sqp_iters
    return {P.kernel: n}


def dict_solve_inputs(P, B: int, steps: int):
    """The arguments of the last of ``steps`` solves of a DX path's f32
    general runner on B lanes (the closed loop's own lanes): (z or zeta,
    u_prev, sqYr, U_plan[, lam])."""
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    mpc, seen = P.mpc, {}
    solve = mpc.solve

    def record(*a):
        seen["args"] = a
        return solve(*a)
    mpc.solve = record
    try:
        P.sim.batched_runner(blockM_reference(), steps=steps + 1)(
            *dict_lanes(P, B))
    finally:
        del mpc.solve
    return seen["args"]


def dict_kernel_args(P, B: int, steps: int) -> dict:
    """{dtype: the kernel's (and its plain version's) arguments} at the
    lanes of ``dict_solve_inputs``, in f32 and f64: ``bilin_lift`` from
    zeta, ``bilin`` from the lifted state, each from the shifted plan with
    the carried duals in row units; ``nmpc_pass`` the first SQP pass (the
    held plan, the jacfwd Jacobians at the held state, rho)."""
    import torch
    args = dict_solve_inputs(P, B, steps)
    out = {}
    for dt, m in ((torch.float32, P.mpc), (torch.float64, P.mpc64)):
        a = tuple(t.to(dt).contiguous() if torch.is_tensor(t) else t
                  for t in args)
        it = m.cfg.qp_iters
        if P.kernel == "nmpc_pass":
            zeta, up, sq = a[:3]
            Np, mm = m.Np, m.m
            Ul = up.repeat(Np, 1)
            Jt, cv = m.stage_lin(zeta.expand((Np,) + zeta.shape), Ul)
            rho = m.cfg.sqp_damping
            out[dt] = (m.nmpc_qp(m.RdT_t + rho * m.bsizes_t), Jt, cv, zeta,
                       up, sq, (m.Sel_t @ Ul[mm:]).contiguous(),
                       (-2.0 * rho * (m.Tb_t.T @ Ul[mm:])).contiguous(),
                       None, it, 1e-2)
            continue
        z, up, sq, U = a[:4]
        lam = a[4] if len(a) > 4 else None
        qp = m.lift_qp() if P.kernel == "bilin_lift" else m.bilin_qp()
        lam_row = None if lam is None else (lam * qp.row[:, None]) \
            .contiguous()
        out[dt] = (qp, z, up, m.warm_start(U).contiguous(), lam_row, sq, it,
                   1e-2)
    return out


def phase_dictionaries(dev, drive, check_qp, ptx, D, smi) -> dict:
    """Phase DX: every dictionary the JAX trainer builds, from training to
    the closed loop on the card (``DICT_REFS``).

    DX1 trains the five dictionary assets' recipes (the delayed poly-2
    bilinear model with PCA, poly-3 without PCA, fourier_sparser 1
    bilinear and nonlinear, poly-2 + 20 gaussians linear), a linear
    hermite-2 and a linear full-fourier-1 model and two continuous-time
    ones (linear poly-1, bilinear poly-2) on the card and on the CPU: the
    card's within 1.2e-7 of the CPU's and of the JAX-trained asset in
    scaled one-step prediction (or of JAX's predictions in the refs for
    the four without an asset), or within twice the training's one-ulp
    lift floor (``lift_ulp_floor``) where that is more; the continuous
    ones within 1e-5 (their generator logm(K') amplifies the fit's last
    bits).  DX2 holds the new builds to their plain versions and f64
    (``check_qp``) on closed-loop lanes (B_CHECK lanes after
    ``DX_CHECK_STEPS`` steps of each path's own loop) and times each at
    B_GENERAL beside its bound.  DX3 runs every path's B=16 loop on the
    card in f32: each lane alive as JAX x64's or as one of JAX's own f32
    runs' (``dict_alive_gate``), its err_mean within 1e-3 of the hull of
    x64's and the band of JAX's own 96 f32 runs, but at most two lanes of
    a chaotic band (``dict_lane_gate``).  DX4 runs every path at
    B_GENERAL x 301 steps through its kernel (launches counted), alive 1.0
    wherever the refs keep all 16 lanes alive, in x64 and in every JAX
    f32 run (``dict_all_alive``); DX5
    times the jacfwd stage Jacobians at B_GENERAL x Np.  Returns each
    build's launches, error, times and bound for the kernels line."""
    import numpy as np
    import torch

    from koopman_realizations_torch.config import SysidConfig
    from koopman_realizations_torch.models.edmd import STAGES, Ksysid
    from koopman_realizations_torch.ops.kernels import bilin as BI
    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
    from koopman_realizations_torch.utils.checkpoint import load_model
    from koopman_realizations_torch.utils.data import load_corpus
    from koopman_realizations_torch.utils.metrics import (
        lane_tracking_error,
        one_step_predictions,
    )
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    refs = D.refs
    ref = blockM_reference()
    t_phase = [time.perf_counter()]

    def took(label):
        now = time.perf_counter()
        log(f"{label} took {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # ---- DX1: every recipe trained on the card, against the CPU and JAX
    ds = load_corpus()
    for name, recipe in refs["sysid"].items():
        cfg = SysidConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in recipe.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks, _, _ = drive({}, lambda: Ksysid(ds, cfg, device=dev)
                         .train_models())
        wall = time.perf_counter() - t0
        cpu = Ksysid(ds, cfg, device="cpu").train_models()
        osp = lambda m: one_step_predictions(m, ks.valdata, dev)
        card = osp(ks.model)
        d_cpu = float(np.abs(card - osp(cpu.model)).max())
        if name in refs["assets"]:
            asset = load_model(DICT_REFS.parent / refs["assets"][name])[0]
            d_jax = float(np.abs(card - osp(asset)).max())
            what = "the JAX-trained asset"
        else:
            jr = np.asarray(refs["trainings"][name]["one_step"])
            d_jax = float(np.abs(card[:len(jr)] - jr).max())
            what = f"JAX's training (its first {len(jr)} predictions)"
        cont = cfg.time_type == "continuous"
        floor = 0.0
        if not cont and max(d_cpu, d_jax) > 1.2e-7:
            floor = lift_ulp_floor(cpu)
        lim = 1e-5 if cont else max(1.2e-7, 2.0 * floor)
        ms = ks.stage_ms()
        log(f"DX1 {name} ({cfg.model_type}, {cfg.time_type}, "
            f"{list(zip(cfg.obs_type, cfg.obs_degree))}, delays "
            f"{cfg.delays}, PCA {cfg.dim_red}) trained on the card: N "
            f"{ks.N}, N_full {ks.basis.N_full}; stages (CUDA events, ms) "
            + ", ".join(f"{k} {ms.get(k, 0.0):.2f}" for k in STAGES)
            + f"; wall {wall:.3f} s; one-step distance to the CPU's "
              f"training {d_cpu:.3e}, to {what} {d_jax:.3e} (bound "
              f"{lim:.3e}" + (f": twice the one-ulp lift floor {floor:.3e}"
                              if lim > 1.2e-7 and not cont else "")
            + f") | {smi}")
        if not (d_cpu <= lim and d_jax <= lim and np.isfinite(card).all()):
            raise AssertionError(f"DX1 {name}: the card's training is off")
        del ks, cpu
    took("DX1")

    # ---- DX2: the new builds against their plain versions and f64, and
    # their times at B_GENERAL
    fns = {"bilin_lift": (BL.bilin_lift_cuda, BL.bilin_lift_plain),
           "bilin": (BI.bilin_cuda, BI.bilin_plain),
           "nmpc_pass": (NP.nmpc_pass_cuda, NP.nmpc_pass_plain)}
    builds = {}
    for name in ("del1", "nopca", "fs1", "nmpc-fs1", "nmpc-bilin"):
        P = D.paths[name]
        a = dict_kernel_args(P, B_CHECK, DX_CHECK_STEPS)
        a32, a64 = a[torch.float32], a[torch.float64]
        qp = a32[0]
        b = qp.cFr[:, None] - qp.F0r @ a32[4 if P.kernel == "nmpc_pass"
                                           else 2]
        lab = (f"({name}: " + (f"nz={qp.nz}, {qp.nmono} monomials"
                               if P.kernel == "bilin_lift" else
                               f"NL={qp.nzl}" if P.kernel == "bilin" else
                               f"jacfwd, nz={qp.nz}, nza={qp.nza}")
               + f", n={qp.n}, mc={qp.mc}) B={B_CHECK} after "
                 f"{DX_CHECK_STEPS} closed-loop steps")
        err, _ = check_qp(P.kernel, fns[P.kernel], a32, a64,
                          P.mpc.constraints(), b, lab)
        # the same lanes tiled to B_GENERAL for the times
        rep = B_GENERAL // B_CHECK
        big = tuple(t.repeat(*([1] * (t.ndim - 1)), rep).contiguous()
                    if torch.is_tensor(t) and t.ndim > 1 else t
                    for t in a32)
        if P.kernel == "nmpc_pass":
            flops = nmpc_onepass_ops(qp, "jacobians", P.cfg.qp_iters, True,
                                     False) * B_GENERAL
            lane_in = nbytes(*big[1:8])
        else:
            flops = qp_ops(qp, P.cfg.qp_iters) * B_GENERAL
            lane_in = nbytes(*(t for t in big[1:6] if t is not None))
        b_ms, b_by = bound(flops, lane_in + 4 * B_GENERAL
                           * (qp.n + 2 * qp.mc + 1)
                           + nbytes(*(t for t in qp if torch.is_tensor(t))))
        k_ms = cuda_ms(lambda: fns[P.kernel][0](*big), reps=10)
        p_ms = cuda_ms(lambda: fns[P.kernel][1](*big), reps=2, warmup=1)
        builds[name] = {"kernel": P.kernel, "err": err, "ms": k_ms,
                        "plain": p_ms, "bound": b_ms, "by": b_by}
        log(f"DX2 {P.kernel} {lab.split(')')[0][1:]}) at B={B_GENERAL}: "
            f"{k_ms:.4f} ms (plain {p_ms:.2f} ms, bound {b_ms:.5f} ms by "
            f"{b_by}, {flops / B_GENERAL:.0f} op/lane); ptxas: "
            f"{ptx(P.spec)} | {smi}")
        del a, a32, a64, big
    took("DX2")

    # ---- DX4: every path at B_GENERAL x 301 steps through its kernel
    launches = {}
    for name, P in D.paths.items():
        X0, W = dict_lanes(P, B_GENERAL)
        steps = DX_JACFWD_STEPS if P.kernel == "nmpc_pass" else STEPS
        run = P.sim.batched_runner(ref, steps=steps)
        P.sim.batched_runner(ref, steps=3)(X0, W)          # warm-up, capture
        res, wall, counts = drive(dict_launches(P, steps),
                                  lambda: run(X0, W))
        e = lane_tracking_error(res["Yp"], ref[:steps]).cpu().numpy()
        alive = res["alive"][:, -1].cpu().numpy()
        all16 = dict_all_alive(P.r)
        log(f"DX4 {name} ({P.model.meta.model_type}, "
            f"{list(P.model.basis.families)}, nd {P.model.meta.nd}, PCA "
            f"{P.model.basis.pcs is not None}, NL {P.model.meta.NL}; "
            f"{P.r['plant']} plant; {P.kernel}, qp_iters "
            f"{P.cfg.qp_iters}) B={B_GENERAL} x {steps} steps: "
            f"{wall:.3f} s (CUDA events), "
            f"{B_GENERAL * (steps - 1) / wall:.4e} lane-steps/s, alive "
            f"{alive.mean():.6f}, err_mean {e.mean():.6f}, err_worst "
            f"{e.max():.6f}, launches "
            f"{ {k: v for k, v in counts.items() if v} }; the refs keep "
            f"all 16 lanes alive in x64 and JAX f32: {all16} | {smi}")
        full = P.r.get("full_f32")
        for key in ("full", "full_f32"):
            # random lanes (the model in the loop): JAX on the same
            # B_GENERAL lanes loses some (the most extreme draws), more
            # of them in x64 than in f32
            fw = P.r.get(key)
            if fw is None or fw["B"] != len(alive):
                continue
            dead = np.asarray(fw["dead"], np.int64)
            both = np.ones(len(alive), bool)
            both[dead] = False
            both &= alive
            log(f"DX4 {name} against JAX {'x64' if key == 'full' else 'f32'}"
                f" on the same {fw['B']} lanes: alive {alive.mean():.6f} "
                f"(JAX {fw['alive']:.6f}; {int((~alive[dead]).sum())} of "
                f"JAX's {len(dead)} lost lanes lost here too, "
                f"{int((~alive).sum()) - int((~alive[dead]).sum())} others), "
                f"err_mean over the lanes alive in both "
                f"{e[both].mean():.6f} (JAX {fw['err_mean']:.6f} over its "
                f"alive lanes)")
        if full is not None and full["B"] == B_GENERAL:
            ok = abs(alive.mean() - full["alive"]) <= 5e-3
        else:
            ok = alive.all() if all16 else True
        if not (np.isfinite(e[alive]).all() and ok):
            raise AssertionError(f"DX4 {name}: lanes lost at full width")
        launches[name] = counts[P.kernel]
        del res
    took("DX4")
    # ---- DX5: the jacfwd route's host cost, the stage Jacobians by
    # forward-mode AD at B_GENERAL lanes x Np stages
    for name in ("nmpc-fs1", "nmpc-bilin"):
        m = D.paths[name].mpc
        g = torch.Generator(device=dev).manual_seed(0)
        Zl = 0.3 * torch.randn((m.Np, m.nz, B_GENERAL), generator=g,
                               device=dev)
        Ul = 0.3 * torch.randn((m.Np * m.m, B_GENERAL), generator=g,
                               device=dev)
        j_ms = cuda_ms(lambda: m.stage_jacobians(Zl, Ul), reps=5)
        l_ms = cuda_ms(lambda: m.stage_lin(Zl, Ul), reps=5)
        log(f"DX5 {name} jacfwd stage Jacobians at B={B_GENERAL} x Np="
            f"{m.Np}: {j_ms:.3f} ms (CUDA events; with F and the defects "
            f"{l_ms:.3f} ms) a pass | {smi}")
    took("DX5")
    # ---- DX3: the B=16 loops in f32 against the JAX references
    B16 = refs["B"]
    for name, P in D.paths.items():
        r = P.r
        res = P.sim.batched_runner(ref, steps=refs["steps"])(
            *dict_lanes(P, B16))
        e = lane_tracking_error(res["Yp"], ref).cpu().numpy()
        alive = res["alive"][:, -1].cpu().numpy()
        lanes_ok, off, loose = dict_lane_gate(e, r)
        x64 = np.asarray(r["err_mean"])
        band = np.asarray(r["f32"]["band"])
        log(f"DX3 {name} (qp_iters {r['qp_iters']}, {P.kernel}) B={B16} x "
            f"{refs['steps']} f32 on the card: err_mean {e.mean():.6f} "
            f"(JAX x64 {x64.mean():.6f}), alive {int(alive.sum())}/{B16} "
            f"(JAX x64 {sum(r['alive'])}, JAX f32 "
            f"{sum(r['f32']['alive'])}), outside the hull of x64 and the "
            f"JAX f32 band by at most {off.max():.3e} (lane "
            f"{int(off.argmax())}; bound 1e-3)" + "".join(
                f"; lane {i} {e[i]:.6f} outside by {off[i]:.3e} (x64 "
                f"{x64[i]:.6f}, band {band[i, 0]:.6f} to {band[i, 1]:.6f})"
                for i in loose) + f" | {smi}")
        if not (dict_alive_gate(alive, r) and lanes_ok):
            raise AssertionError(f"DX3 {name}: off the JAX reference")
    took("DX3")

    arm_of = next(P.plant for P in D.paths.values()
                  if hasattr(P.plant, "clear_graphs"))
    arm_of.clear_graphs()
    return {"builds": builds, "launches": launches}


def gram_conds(datasets, r) -> tuple:
    """The condition number of the ridged Gram matrix that
    ``evaluate_rand_models`` solves for each system at each degree of the
    two least-squares families ({family: (degrees, S)}), f64 on the CPU
    (``workflows/rand_models.py:_fit_and_val``'s pairs, rows and ridge),
    and the number of snapshot pairs each Gram sums."""
    import numpy as np
    import torch

    from koopman_realizations_torch.ops.lstsq import ridge_for_dtype
    from koopman_realizations_torch.workflows import rand_models as RM

    Ytr, Utr, _, _ = RM._stack_ensemble(datasets)
    y_fac, y_off, u_fac, u_off = RM._scale_params(Ytr, Utr)
    Y = torch.from_numpy((Ytr - y_off[:, None, None]) / y_fac[:, None, None])
    U = torch.from_numpy((Utr - u_off[:, None, None]) / u_fac[:, None, None])
    S = Y.shape[0]
    a = Y[:, :, :-1].reshape(S, -1)[:, :-1]
    u = U[:, :, :-1].reshape(S, -1)[:, :-1]
    out = {}
    for fam in ("linear", "bilinear"):
        conds = []
        for d in range(1, r[f"max_degree_{fam}"] + 1):
            Px = RM._rows(a, u, d, fam)
            G = Px.mT @ Px
            n = G.shape[-1]
            scale = torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
                                / n, min=1.0)
            ridge = ridge_for_dtype(G.dtype) * scale[:, None, None]
            conds.append(torch.linalg.cond(
                G + ridge * torch.eye(n, dtype=G.dtype)).numpy())
        out[fam] = np.stack(conds)
    return out, a.shape[1]


def phase_rand_models(dev, smi):
    """Phase RS: the random-system sweep at the reference's scale.

    ``RAND_MODELS``'s ensemble drawn from its seed, simulated (one batched
    RK4 over 20 x 11 lanes, 500 samples of 8 substeps) and swept
    (``evaluate_rand_models`` at degrees 13 / 6 / 4, the nonlinear family
    by 500 FISTA iterations at lasso 4: 460 fits) on the card and on the
    CPU, both f64, each timed.  Gates: trajectories within rtol 1e-10;
    each family's kept mask equal and every kept error within atol 1e-9
    and an rtol of 1e-6, or, where f64 fixes a least-squares fit less
    closely than that, of its ridged Gram's condition number
    (``gram_conds``) times the Gram's typical rounding sqrt(pairs) * eps
    (the highest linear degrees reach cond ~2e10; the farthest three fits
    of every family are logged); the card's medians within rtol 1e-6 of the
    JAX references (``assets/rand_models_refs.json``) and its kept counts
    equal."""
    import numpy as np
    import torch

    from koopman_realizations_torch.models.rsys import (
        construct_systems,
        simulate_systems,
    )
    from koopman_realizations_torch.workflows import evaluate_rand_models

    r = RAND_MODELS
    refs = json.loads(RAND_REFS.read_text())["families"]
    runs = {}
    for d in (dev, "cpu"):
        rng = np.random.default_rng(r["seed"])
        ens = construct_systems(r["num_sys"], r["num_terms"], r["degree_x"],
                                r["degree_u"], rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = simulate_systems(ens, r["t_end"], r["Ts"], r["num_trials"],
                              rng, device=d)
        t1 = time.perf_counter()
        res = evaluate_rand_models(
            ds, r["max_degree_linear"], r["max_degree_bilinear"],
            r["max_degree_nonlinear"], r["nonlinear_lasso"],
            r["lasso_iters"], device=d)
        torch.cuda.synchronize()
        runs[str(d)] = (ds, res, t1 - t0, time.perf_counter() - t1)
    (dc, rc, sc, ec), (dh, rh, sh, eh) = runs[str(dev)], runs["cpu"]
    y = lambda dss: np.stack([tr.y[:, 0] for d_ in dss
                              for tr in d_.train + d_.val])
    traj = float(np.max(np.abs(y(dc) - y(dh)) / np.abs(y(dh)).clip(1e-300)))
    log(f"RS ensemble of {r['num_sys']} systems x {r['num_trials']} trials "
        f"(t_end {r['t_end']:g}, Ts {r['Ts']:g}): simulation {sc:.3f} s on "
        f"the card, {sh:.3f} s on the CPU; sweep (460 fits) {ec:.3f} s on "
        f"the card, {eh:.3f} s on the CPU; trajectories card vs CPU max "
        f"rel {traj:.3e} | {smi}")
    ok = traj <= 1e-10
    conds, pairs = gram_conds(dh, r)
    # each kept fit's rtol: 1e-6, or where f64 fixes a least-squares fit
    # less closely, its ridged Gram's condition number times the Gram's
    # typical rounding sqrt(pairs) * eps (in the run that set this rule,
    # the card and the CPU parted by a quarter of that at most: 1.5e-6 at
    # cond 3.9e8, 6.8e-6 at cond 2.2e9)
    fix = np.sqrt(pairs) * np.finfo(np.float64).eps
    for fam in ("linear", "bilinear", "nonlinear"):
        c, h, j = rc[fam], rh[fam], refs[fam]
        keep = lambda e: np.all(np.isfinite(e), 0) & np.all(e < 10, 0)
        kc, kh = keep(c["err"]), keep(h["err"])
        same = bool(np.array_equal(kc, kh))
        rel = np.abs(c["err"] - h["err"]) / np.abs(h["err"])
        rtol = np.maximum(1e-6, conds[fam] * fix) if fam in conds \
            else np.full_like(rel, 1e-6)
        held = np.broadcast_to(kc[None], rel.shape)
        wide = held & (rtol > 1e-6)
        d_med = float(np.max(np.abs(c["median"] - np.asarray(j["median"]))
                             / np.abs(np.asarray(j["median"]))))
        log(f"RS {fam}: kept {c['kept']} (CPU {h['kept']}, JAX "
            f"{j['kept']}), masks equal {same}; medians "
            + " ".join(f"{v:.6f}" for v in c["median"])
            + f"; kept errors card vs CPU max rel {rel[held].max():.3e} over "
            f"{int(held.sum())} fits, at most {(rel / rtol)[held].max():.3f}"
            f" of each fit's rtol"
            + (f" ({int(wide.sum())} fits whose Gram has cond * sqrt({pairs})"
               f" * eps > 1e-6, cond up to {conds[fam].max():.2e}: max rel "
               f"{rel[wide].max():.3e}, rtol up to {rtol[wide].max():.3e})"
               if wide.any() else "")
            + "; the farthest: " + ", ".join(
                f"degree {d + 1} system {q} {rel[d, q]:.2e}" + (
                    f" (cond {conds[fam][d, q]:.1e})" if fam in conds
                    else "")
                for d, q in zip(*np.unravel_index(
                    np.argsort(np.where(held, rel, 0.0), axis=None)[-3:],
                    rel.shape)))
            + f"; medians vs JAX max rel {d_med:.3e}")
        ok &= same and c["kept"] == j["kept"] and d_med <= 1e-6
        ok &= bool(np.all(np.abs(c["err"] - h["err"])[held]
                          <= 1e-9 + rtol[held] * np.abs(h["err"])[held]))
    if not ok:
        raise AssertionError("RS: the random-system sweep is off the CPU "
                             "or the JAX reference")


# a __global__ function of the port's CUDA sources
# ---- phase RN: the harness in full, the fused step on the default plant
# and on angle outputs, and the controller knobs
# the JAX x64 general runner on ArmConfig()'s defaults and on the angle
# models (tests/test_torch_oracle.py --write-angles), and on every knob
# (--write-knob-refs)
RUNNER_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "runner_refs.json"
KNOB_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "knob_refs.json"
# the default plant: ArmConfig() (SDIRK2, a Jacobian every substep, 10
# substeps, 3 Newton iterations) with the bench's geometry
DEFAULT_ARM = dict(Nmods=3, nlinks=1, L=1.0, m=0.1)
# the four fused loops (tests/test_torch_oracle.py:RUNNER_PATHS): asset,
# controller, outputs
RUNNER_LOOPS = {
    "default_bilinear": ("arm3_bilinear_poly3.npz", "bilinear", "markers"),
    "default_linear": ("arm3_linear_poly3.npz", "linear", "markers"),
    "angles_bilinear": ("arm3_angles_bilinear_poly3.npz", "bilinear",
                        "angles"),
    "angles_linear": ("arm3_angles_linear_poly3.npz", "linear", "angles"),
}
# the MATLAB reference's per-step solve times (BASELINE.md, mean ms, one
# CPU): linear, bilinear, nonlinear
MATLAB_COMP_MS = {"linear": 6.1, "bilinear": 9.6, "nonlinear": 1159.0}
# the linear unblocked stack cold: its n=27 builds without duals (RN1)
COLD = dict(qp_dual_warm=False, qp_iters=24)
# the closed-loop steps before RN1's state-bound QPs: the knob's capped
# bound binds on every lane from about step 36 of blockM
SB_STEPS = 40
# the plain per-lane-A loop (no kernel) runs RN4 at this many lanes
B_PLAIN = B_CHECK
# RN4's loops and RN3's lasso sweep at 65536 lanes run this many steps
# (cut from 301 for the time limit when phase GN came: the state-bound
# loops 26 s and 19 s, the sweep 25 s, the others ~3 s at 301 steps);
# their gate is alive at full width
RN4_STEPS = 101
# del1's bilin_lift build on this many closed-loop lanes, where its p99
# distance to f64 once read 3x plain f32's (ROADMAP.md §3, check 3)
B_TAIL = 129


def rn_config(entry: dict, base: dict = None):
    """An ``MpcConfig`` from a refs entry's knobs or config (lists as
    tuples), over ``base``."""
    from koopman_realizations_torch.config import MpcConfig
    import dataclasses
    fields = {f.name for f in dataclasses.fields(MpcConfig)}
    tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, list) else v
    return MpcConfig(**{**(base or {}), **{k: tup(v) for k, v in
                                           entry.items() if k in fields}})


def sb_rows(m) -> slice:
    """The state-bound rows of an unblocked controller's QP (the last
    2 n (Np - 1), after the input rows)."""
    return slice(m.n_con - 2 * m.n * (m.Np - 1), m.n_con)


def rn_setup(dev):
    """Phase RN's references, controllers (f32 and f64), plants, fused
    ops and the specs of its new builds: both fused steps with
    jac_mode 'substep' on markers and on angles (four builds), and
    ``ipm_shared``'s lane-shared builds with warm duals (n=12) and at the
    linear unblocked shape n=27 without (band 3, cold) and with (dense,
    warm and cold) the state-bound rows."""
    import numpy as np
    import torch

    from koopman_realizations_torch.config import ArmConfig
    from koopman_realizations_torch.control.kmpc import make_kmpc
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.ops.kernels import (
        linear_step_fused as LS,
    )
    from koopman_realizations_torch.ops.kernels import step_fused as SF
    from koopman_realizations_torch.utils.checkpoint import load_model
    assets = RUNNER_REFS.parent
    R = types.SimpleNamespace(refs=json.loads(RUNNER_REFS.read_text()),
                              krefs=json.loads(KNOB_REFS.read_text()),
                              loops={}, knobs={}, specs={})
    R.angle_ref = np.asarray(R.refs["angle_reference"])
    arms = {o: Arm(ArmConfig(**DEFAULT_ARM, output_type=o), device=dev)
            for o in ("markers", "angles")}
    R.arms = arms
    for name, (asset, kind, outs) in RUNNER_LOOPS.items():
        r = R.refs["paths"][name]
        model, scaler, _ = load_model(assets / asset)
        cfg = rn_config(r["config"])
        L = types.SimpleNamespace(r=r, kind=kind, scaler=scaler, cfg=cfg)
        L.mpc = make_kmpc(model, scaler, cfg, device=dev)
        L.mpc64 = make_kmpc(model, scaler, cfg, device=dev,
                            dtype=torch.float64)
        L.arm = arms[outs]
        L.sim = Ksim(L.arm, L.mpc, device=dev)
        if not L.sim.fused_step_eligible():
            raise AssertionError(f"RN {name}: not eligible for the fused "
                                 f"step")
        build = SF.build_step_fused if kind == "bilinear" \
            else LS.build_linear_step_fused
        L.op = build(L.mpc, L.arm, scaler)
        L.op64 = build(L.mpc64, L.arm, scaler)
        L.ref = R.angle_ref if outs == "angles" else None
        R.specs[name] = L.op.kernel_spec()
        R.loops[name] = L
    from koopman_realizations_torch.utils.checkpoint import LINEAR_MODEL
    ARM_BENCH = Arm(ArmConfig(**ARM), device=dev)
    R.arm_bench = ARM_BENCH
    for name, r in R.krefs["paths"].items():
        model, scaler, _ = load_model(assets / r["asset"])
        cfg = rn_config(r["config"])
        K = types.SimpleNamespace(r=r, cfg=cfg, model=model, scaler=scaler)
        K.mpc = make_kmpc(model, scaler, cfg, device=dev)
        K.mpc64 = make_kmpc(model, scaler, cfg, device=dev,
                            dtype=torch.float64)
        K.sim = Ksim(ARM_BENCH, K.mpc, device=dev)
        K.kernel = "bilin_lift" if getattr(K.mpc, "lift_fused", False) \
            else "ipm_shared" if r["asset"].startswith("arm3_linear") \
            else None
        R.knobs[name] = K
    # the linear controller unblocked and cold, without state bounds
    # (n=27, band 3) and with the knob's (n=27, dense)
    lmodel, lscaler, _ = load_model(LINEAR_MODEL)
    sb = R.krefs["paths"]["linear_unblocked_sb"]["config"]
    for key, cfg in (("ub", rn_config(dict(sb, state_bounds=None, **COLD))),
                     ("sb_cold", rn_config(dict(sb, **COLD)))):
        K = types.SimpleNamespace(
            cfg=cfg, mpc=make_kmpc(lmodel, lscaler, cfg, device=dev),
            mpc64=make_kmpc(lmodel, lscaler, cfg, device=dev,
                            dtype=torch.float64))
        K.sim = Ksim(ARM_BENCH, K.mpc, device=dev)
        setattr(R, key, K)
    R.shared_builds = {"warm n=12": (R.knobs["linear_dual_shift"], 5),
                       "n=27 band 3 cold": (R.ub, 5),
                       "n=27 dense": (R.knobs["linear_unblocked_sb"],
                                      SB_STEPS),
                       "n=27 dense cold": (R.sb_cold, SB_STEPS)}
    for label, (K, _) in R.shared_builds.items():
        R.specs["ipm_shared " + label] = IS.kernel_spec(
            K.mpc.constraints(), warm=K.mpc.cfg.qp_dual_warm)
    return R


def shared_qp_args(K, loop) -> tuple:
    """The ``ipm_shared`` arguments of a linear controller's next solve at
    a general loop's carries (``_Loop``; ``LinearKmpc.qp_args``), in f32
    (``K.mpc``) and f64 (``K.mpc64``): ({dtype: the kernel's arguments},
    the f32 rows, the f32 b in row units)."""
    import torch
    out = {}
    for dt, m in ((torch.float32, K.mpc), (torch.float64, K.mpc64)):
        c = lambda t: None if t is None else t.to(dt)
        out[dt] = m.qp_args(m.lift(c(loop.ysc)), c(loop.upsc),
                            c(loop.windows[loop.k]), c(loop.U_plan),
                            c(loop.lam))[0]
    return out, out[torch.float32][0], out[torch.float32][3]


def del1_tail(D) -> dict:
    """Phase RN6 (ROADMAP.md §3, open check 3): ``bilin_lift``'s del1
    build against plain f32 and f64 on B_TAIL lanes after DX_CHECK_STEPS
    closed-loop steps of del1's loop -- the median and p99 distance to
    f64, and for the two farthest lanes their smallest slack, gap and
    distance to the f64 solution by iterations (the lane alone, 1 to
    twice the loop's count), with a verdict: an f32 tail where plain f32
    is as far on that lane (within 4x) or the lane is degenerate (its f64
    smallest slack below 1e-6), else a kernel fault.  Returns the p99s
    and whether every verdict is an f32 tail."""
    import torch

    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    lv = torch.tensor([0.5, 0.99], dtype=torch.float64,
                      device=D.paths["del1"].mpc.device)
    P = D.paths["del1"]
    a = dict_kernel_args(P, B_TAIL, DX_CHECK_STEPS)
    a32, a64 = a[torch.float32], a[torch.float64]
    qp = a32[0]
    rk = BL.bilin_lift_cuda(*a32)
    torch.cuda.synchronize()
    rp = BL.bilin_lift_plain(*a32)
    r64 = BL.bilin_lift_plain(*a64)
    dk = (rk[0].double() - r64[0]).abs().amax(0)
    dp = (rp[0].double() - r64[0]).abs().amax(0)
    qk, qp_ = torch.quantile(dk, lv), torch.quantile(dp, lv)
    log(f"RN6 bilin_lift del1 (nz={qp.nz}, {qp.nmono} monomials, n={qp.n},"
        f" mc={qp.mc}, {P.cfg.qp_iters} iterations) B={B_TAIL} after "
        f"{DX_CHECK_STEPS} closed-loop steps: distance to f64 (median, p99)"
        f" kernel {qk[0]:.3e} {qk[1]:.3e}, plain f32 {qp_[0]:.3e} "
        f"{qp_[1]:.3e}")
    lane = lambda t, i: t[..., i:i + 1].contiguous() \
        if torch.is_tensor(t) and t.ndim > 1 else t
    verdicts = []
    for i in [int(j) for j in torch.argsort(dk, descending=True)[:2]]:
        trace = []
        for it in (1, 2, 4, 6, 8, P.cfg.qp_iters, 2 * P.cfg.qp_iters):
            one = lambda aa: tuple(lane(t, i) for t in aa[:6]) + (it,) \
                + tuple(aa[7:])
            x_i = r64[0][:, i:i + 1]
            far = lambda x: (x.double() - x_i).abs().max().item()
            trace.append(
                f"{it}: kernel {far(BL.bilin_lift_cuda(*one(a32))[0]):.2e}"
                f" plain {far(BL.bilin_lift_plain(*one(a32))[0]):.2e} "
                f"f64 {far(BL.bilin_lift_plain(*one(a64))[0]):.2e}")
        smin = [r[1][:, i].min().item() for r in (rk, rp, r64)]
        gap = [(r[1][:, i] * r[2][:, i]).mean().item() for r in (rk, rp, r64)]
        degenerate = smin[2] < 1e-6
        f32_tail = dp[i] > 0.25 * dk[i] or degenerate
        verdicts.append(f32_tail)
        log(f"RN6 lane {i}: distance to f64 kernel {dk[i]:.3e}, plain f32 "
            f"{dp[i]:.3e}; smallest slack kernel {smin[0]:.3e} plain "
            f"{smin[1]:.3e} f64 {smin[2]:.3e}; gap kernel {gap[0]:.3e} "
            f"plain {gap[1]:.3e} f64 {gap[2]:.3e}; the lane alone by "
            f"iterations (distance to the f64 solution at "
            f"{P.cfg.qp_iters}): " + "; ".join(trace) + "; verdict: "
            + ("an f32 tail (plain f32 is as far on this lane"
               + (", a degenerate lane" if degenerate else "") + ")"
               if f32_tail else "the kernel alone is far: a kernel fault"))
    return {"p99": [float(qk[1]), float(qp_[1])],
            "f32_tail": all(verdicts)}


def phase_runners(dev, E, R, D, smi) -> dict:
    """Phase RN: the harness in full, the fused step on the default plant
    and on angle outputs, and the controller knobs (``RUNNER_REFS``,
    ``KNOB_REFS``).

    RN1 holds the new builds to their plain versions and f64: the fused
    steps in 'substep' on markers and angles (one step at B_CHECK and at
    B_MAIN, and 10-step runners from the same lanes against plain f32 and
    f64: median and p99 distance of the tracked outputs to f64 within
    twice plain f32's), and ``ipm_shared``'s warm-dual (n=12) and n=27
    builds (``check_qp``: median and p99 distance to f64) on the QPs of
    B_CHECK closed-loop lanes; each build timed beside its bound and its
    plain version.  RN2 runs the four fused loops at B_MAIN x 301: alive
    1.0 where JAX x64 keeps the 16 lanes alive, err_mean within 1e-3 of
    the refs.  RN3 runs each knob at B=16 x 301 against the JAX x64
    values (err_mean within 1e-3, alive equal, or lane by lane within the
    hull of x64 and JAX's f32 band where its loop amplifies f32 rounding)
    and the lasso sweep at ``bilinear_iters=2`` on the six committed
    candidates (each within 1e-3 of x64, or inside its f32 band), the
    state-bound knobs with a state-bound row active on some lane-step;
    RN4 the same at B_GENERAL x RN4_STEPS (the loop that runs no kernel, the
    bilinear state-bound one, at B_PLAIN), every lane alive where JAX
    keeps the 16 lanes alive in x64 and every f32 run.  RN5 times
    ``run_trial_mpc_timed`` at B=1 on blockM for the linear, bilinear and
    NMPC controllers beside the MATLAB reference's per-step times.  RN6
    logs ``bilin_lift``'s del1 build at B_TAIL lanes: its farthest lanes'
    distances to f64, smallest slack and iteration trace (ROADMAP.md §3,
    open check 3).  Returns the launches, errors, times and bounds for
    the kernels line."""
    import dataclasses

    import numpy as np
    import torch

    from koopman_realizations_torch.control.ksim import _Loop
    from koopman_realizations_torch.models.koopman import from_jax_arrays
    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.ops.kernels import (
        linear_step_fused as LS,
    )
    from koopman_realizations_torch.ops.kernels import step_fused as SF
    from koopman_realizations_torch.ops.qp import ok_mask
    from koopman_realizations_torch.utils.metrics import lane_tracking_error
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    from koopman_realizations_torch.workflows.lasso_sweep import (
        lasso_sweep_closed_loop,
    )
    blockM = blockM_reference()
    t_phase = [time.perf_counter()]
    out = {"fused": {}, "ipm_shared": {}, "launches": {}}

    def took(label):
        now = time.perf_counter()
        log(f"{label} took {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    def lanes(B, nx=6):
        X0 = np.zeros((B, nx), np.float32)
        X0[:, 0] = np.linspace(-0.2, 0.2, B)
        return X0, np.zeros((B, 2), np.float32)

    def vecs_of(L, mpc, op):
        ref = blockM if L.ref is None else L.ref
        w = L.sim.reference_windows(ref, STEPS) if mpc is L.mpc else \
            type(L.sim)(L.arm, mpc, device=dev).reference_windows(ref,
                                                                 STEPS)
        return op.fYr(w) if L.kind == "linear" else w

    # ---- RN1: the new builds against their plain versions and f64
    lv = torch.tensor([0.5, 0.99], dtype=torch.float64, device=dev)
    for name, L in R.loops.items():
        kern = "step_fused" if L.kind == "bilinear" else "linear_step_fused"
        v32, v64 = vecs_of(L, L.mpc, L.op), vecs_of(L, L.mpc64, L.op64)
        c = E.carry_after(L.op, v32, B_CHECK, 5)
        err = E.check_step(L.op, c, v32[5], f"RN1 {kern} ({name}) one step "
                           f"B={B_CHECK}")
        ck = E.carry_after(L.op, v32, B_CHECK, 0)
        cp = E.carry_after(L.op, v32, B_CHECK, 0)
        c64 = E.carry_after(L.op64, v64, B_CHECK, 0)
        for k in range(10):
            ck = L.op.step(ck, v32[k])
            cp = L.op.step_plain(cp, v32[k])
            c64 = L.op64.step_plain(c64, v64[k])
        ek = torch.quantile((ck.yp.double() - c64.yp).abs().amax(0), lv)
        ep = torch.quantile((cp.yp.double() - c64.yp).abs().amax(0), lv)
        log(f"RN1 {kern} ({name}: jac_mode 'substep', "
            f"{L.arm.cfg.output_type}) 10-step runners B={B_CHECK}: "
            f"distance of the tracked outputs to f64 (median, p99): "
            f"kernel {ek[0]:.3e} {ek[1]:.3e}, plain f32 {ep[0]:.3e} "
            f"{ep[1]:.3e}; alive kernel {ck.alive.mean().item():.4f} plain "
            f"{cp.alive.mean().item():.4f}")
        if not (torch.equal(ck.alive, cp.alive) and bool(ck.alive.all())
                and bool((ek <= 2 * ep + 1e-4).all())):
            raise AssertionError(f"RN1 {name}: the kernel's runner is "
                                 f"farther from f64 than plain f32")
        X0, W = lanes(B_MAIN)
        cB = L.op.init_carry(X0, W)
        err = max(err, E.check_step(L.op, cB, v32[0], f"RN1 {kern} "
                                    f"({name}) one step B={B_MAIN}"))
        oB = SF.StepCarry(*(torch.empty_like(t) for t in cB))
        ms = E.kernel_ms(kern, lambda: L.op.step(cB, v32[0], out=oB),
                         reps=10, build=name)
        plain = cuda_ms(lambda: L.op.step_plain(cB, v32[0]), reps=1,
                        warmup=1)
        cfg = L.arm.cfg
        cons = L.op.cons
        if L.kind == "bilinear":
            qp = L.op.qp
            qp_flops = qp_ops(qp, L.op.iters)
            tail = step_tail_ops(L.op, cfg, True)
            shared = nbytes(qp.gens, qp.rdiag, qp.A, qp.cFr, qp.F0r, qp.Wd,
                            qp.Wo, L.op.Pwarm)
        else:
            qp_flops = (linear_grad_ops(L.op)
                        + mehrotra_ops(cons, L.op.iters, nnz(L.op.Psh)))
            tail = step_tail_ops(L.op, cfg, False)
            shared = nbytes(L.op.Psh, L.op.G1, L.op.P21, L.op.cFr,
                            L.op.F0r, cons.A, cons.Wd, cons.Wo, L.op.Pwarm)
        plant = plant_ops(cfg)
        flops = (qp_flops + ok_ops(cons) + plant + tail) * B_MAIN
        b_ms, b_by = bound(flops, carry_bytes(cB) + nbytes(v32[0]) + shared)
        # the plant front alone: its operations over the card's f32 rate
        # against the carry it reads and the scratch row it writes
        pf_ms, pf_by = bound(plant * B_MAIN, 4 * B_MAIN * (
            cfg.nx + 2 + L.mpc.m + cfg.nx + cfg.ny + 1))
        step_plant = plant_ops(dataclasses.replace(
            cfg, jac_mode="step", substeps=3, newton_iters=1,
            output_type="markers"))
        log(f"RN1 {kern} ({name}) at B={B_MAIN}: {ms:.4f} ms (plain "
            f"{plain:.2f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"{flops / B_MAIN:.0f} op/lane); the 'substep' plant front "
            f"alone: {plant} op/lane ({plant / step_plant:.2f}x the main "
            f"path's 'step' front, {step_plant}), bound {pf_ms:.4f} ms by "
            f"{pf_by}; {E.plan_of(L.op)} | {smi}")
        out["fused"][name] = {"kernel": kern, "err": err, "ms": ms,
                              "plain": plain, "bound": b_ms, "by": b_by,
                              "plant_bound": pf_ms}
        del cB, oB, ck, cp, c64
    # ipm_shared's new builds on the QPs of B_CHECK closed-loop lanes
    for label, (K, at) in R.shared_builds.items():
        X0, W = lanes(B_CHECK)
        loop = _Loop(K.sim, at + 3, K.sim.reference_windows(blockM, at + 3),
                     K.sim._ref_rows(K.sim.prep_ref(blockM), at + 3), (), X0,
                     W)
        for k in range(at):
            loop.step(k)
        loop.k = at
        a, cons, b = shared_qp_args(K, loop)
        err, _ = E.check_qp("ipm_shared", (IS.ipm_shared_cuda,
                                           IS.ipm_shared_plain),
                            a[torch.float32], a[torch.float64], cons, b,
                            f"(RN1 {label}: n={cons.n}, mc={cons.mc}, band "
                            f"{cons.band}, duals "
                            f"{'warm' if a[torch.float32][8] is not None else 'cold'}) "
                            f"B={B_CHECK} after {at} closed-loop steps")
        if K.mpc.cfg.state_bounds is not None:
            # the state-bound rows the kernel's solution holds active
            lam = IS.ipm_shared_cuda(*a[torch.float32])[2]
            act = (lam[sb_rows(K.mpc)] > 1e-3).any(0)
            log(f"RN1 ipm_shared {label}: a state-bound row active on "
                f"{int(act.sum())} of {B_CHECK} lanes")
            if not bool(act.any()):
                raise AssertionError(f"RN1 {label}: no state-bound row "
                                     f"binds")
        rep = B_GENERAL // B_CHECK
        big = tuple(t.repeat(*([1] * (t.ndim - 1)), rep).contiguous()
                    if torch.is_tensor(t) and t.ndim > 1 and t.shape[-1]
                    == B_CHECK else t for t in a[torch.float32])
        ms = E.kernel_ms("ipm_shared", lambda: IS.ipm_shared_cuda(*big),
                         reps=10, build=label)
        plain = cuda_ms(lambda: IS.ipm_shared_plain(*big), reps=1, warmup=1)
        flops = mehrotra_ops(cons, big[5], nnz(big[1])) * B_GENERAL
        b_ms, b_by = bound(flops, nbytes(*(t for t in big[2:5]))
                           + (nbytes(big[8]) if big[8] is not None else 0)
                           + 4 * B_GENERAL * (cons.n + 2 * cons.mc)
                           + nbytes(big[1], cons.A, cons.Wd, cons.Wo))
        log(f"RN1 ipm_shared {label} at B={B_GENERAL}: {ms:.4f} ms (plain "
            f"{plain:.2f} ms, bound {b_ms:.5f} ms by {b_by}, "
            f"{flops / B_GENERAL:.0f} op/lane); plan "
            f"{IS.launch_plan(cons)} | {smi}")
        out["ipm_shared"][label] = {"err": err, "ms": ms, "plain": plain,
                                    "bound": b_ms, "by": b_by}
        del loop, a, big
    took("RN1")

    # ---- RN2: the four fused loops at B_MAIN x 301
    for name, L in R.loops.items():
        kern = "step_fused" if L.kind == "bilinear" else "linear_step_fused"
        ref = blockM if L.ref is None else L.ref
        run = L.sim.fused_runner(ref, STEPS)
        X0, W = lanes(B_MAIN)
        L.sim.fused_runner(ref, 3)(X0[:1024], W[:1024])        # warm-up
        res, wall, counts = E.drive({kern: STEPS - 1}, lambda: run(X0, W))
        e = lane_tracking_error(res["Yp"], ref).cpu().numpy()
        alive = res["alive"][:, -1].cpu().numpy()
        jr = np.mean(L.r["err_mean"])
        all16 = all(L.r["alive"])
        log(f"RN2 {name} ({kern}, jac_mode 'substep', "
            f"{L.arm.cfg.output_type}, qp_iters {L.cfg.qp_iters}) "
            f"B={B_MAIN} x {STEPS} steps: {wall:.3f} s (CUDA events), "
            f"{B_MAIN * (STEPS - 1) / wall:.4e} lane-steps/s, alive "
            f"{alive.mean():.6f}, err_mean {e[alive].mean():.6f} (JAX x64 "
            f"B=16 {jr:.6f}), err_worst {e.max():.6f} | {smi}")
        if not ((alive.all() or not all16)
                and abs(e[alive].mean() - jr) < 1e-3):
            raise AssertionError(f"RN2 {name}: off the JAX reference")
        out["launches"][name] = counts[kern]
        del res
    took("RN2")

    # ---- RN3, RN4: the knobs at B=16 and B_GENERAL x 301 (a loop that
    # runs no kernel at B_PLAIN)
    krefs = R.krefs
    B16 = krefs["B"]
    for name, K in R.knobs.items():
        r = K.r
        exp = {} if K.kernel is None else {K.kernel: STEPS - 1}
        run = K.sim.batched_runner(blockM, steps=STEPS)
        has_sb = K.cfg.state_bounds is not None
        active, solve = [0], K.mpc.solve

        def counted(*a):
            # lane-steps with a state-bound row active (multiplier > 1e-3)
            U, sol = solve(*a)
            active[0] += int((sol.lam[sb_rows(K.mpc)] > 1e-3).any(0).sum())
            return U, sol

        if has_sb:
            K.mpc.solve = counted
        try:
            res, wall16, _ = E.drive(exp, lambda: run(*lanes(B16)))
        finally:
            if has_sb:
                del K.mpc.solve
        e = lane_tracking_error(res["Yp"], blockM).cpu().numpy()
        alive = res["alive"][:, -1].cpu().numpy()
        x64 = np.asarray(r["err_mean"])
        banded = r["f32"]["copies"] > 1
        if banded:
            lanes_ok, off, loose = dict_lane_gate(e, r)
            ok = dict_alive_gate(alive, r) and lanes_ok
            gate = (f"outside the hull of x64 and JAX's f32 band by at most "
                    f"{off.max():.3e} (lane {int(off.argmax())})")
        else:
            ok = (alive == np.asarray(r["alive"])).all() \
                and abs(e.mean() - x64.mean()) < 1e-3
            gate = f"|d err_mean| {abs(e.mean() - x64.mean()):.3e}"
        sb_note = (f"; a state-bound row active on {active[0]} of "
                   f"{B16 * (STEPS - 1)} lane-steps" if has_sb else "")
        log(f"RN3 {name} ({K.kernel or 'plain per-lane-A IPM'}, qp_iters "
            f"{K.cfg.qp_iters}) B={B16} x {STEPS} f32 on the card: err_mean "
            f"{e.mean():.6f} (JAX x64 {x64.mean():.6f}), alive "
            f"{int(alive.sum())}/{B16} (JAX x64 {sum(r['alive'])}); {gate}"
            f"{sb_note}; {wall16:.3f} s | {smi}")
        if not ok:
            raise AssertionError(f"RN3 {name}: off the JAX reference")
        if has_sb and not active[0]:
            raise AssertionError(f"RN3 {name}: no state-bound row binds")
        B = B_GENERAL if K.kernel else B_PLAIN
        X0, W = lanes(B)
        K.sim.batched_runner(blockM, steps=3)(X0[:1024], W[:1024])
        steps = RN4_STEPS
        run = K.sim.batched_runner(blockM, steps=steps)
        exp = {} if K.kernel is None else {K.kernel: steps - 1}
        res, wall, counts = E.drive(exp, lambda: run(X0, W))
        alive = res["alive"][:, -1].cpu().numpy()
        e = lane_tracking_error(res["Yp"], blockM).cpu().numpy()
        log(f"RN4 {name} B={B} x {steps}: {wall:.3f} s (CUDA "
            f"events), {B * (steps - 1) / wall:.4e} lane-steps/s, "
            f"alive {alive.mean():.6f}, err_mean {e[alive].mean():.6f}, "
            f"launches { {k: v for k, v in counts.items() if v} } | {smi}")
        # every lane alive where JAX keeps the 16 lanes alive in x64 and
        # in every f32 run of it
        if not (np.isfinite(e[alive]).all()
                and (alive.all() or not dict_all_alive(r))):
            raise AssertionError(f"RN4 {name}: lanes lost at full width")
        if K.kernel:
            out["launches"][name] = counts[K.kernel]
        del res
    # the lasso sweep with two relinearized passes a step
    lr = krefs["lasso"]
    data = np.load(LASSO_CANDIDATES)
    header = json.loads(str(data["header"]))
    shared = {k: data[k] for k in data.files
              if k != "header" and not k.startswith(("A_", "B_"))}
    pairs = [from_jax_arrays(dict(header, lasso=lv),
                             dict(shared, A=data[f"A_{i}"], B=data[f"B_{i}"]))
             for i, lv in enumerate(header["lasso"])]
    cands = [m for m, _ in pairs]
    from koopman_realizations_torch.config import ArmConfig
    from koopman_realizations_torch.models.arm import Arm
    sarm = Arm(ArmConfig(**lr["recipe"]["arm"]), device=dev)
    scfg = rn_config(lr["config"])
    for C in (len(cands), B_GENERAL):
        ks = types.SimpleNamespace(
            candidates=[cands[i % len(cands)] for i in range(C)],
            scaler=pairs[0][1])
        steps = STEPS if C == len(cands) else RN4_STEPS
        res, wall, counts = E.drive(
            {"ipm_shared": scfg.bilinear_iters * (steps - 1)},
            lambda: lasso_sweep_closed_loop(ks, sarm, scfg, blockM,
                                            steps=steps, device=dev))
        em = res["err"].mean(1)
        al = res["alive"][:, -1]
        rows = []
        ok = True
        for i, (lval, cd) in enumerate(lr["candidates"].items()):
            e_i = em[i::len(cands)]
            a_i = al[i::len(cands)]
            lo, hi = cd["f32_band"]
            near = abs(e_i - cd["err_mean"]) < 1e-3
            inside = (e_i >= lo - 1e-3) & (e_i <= hi + 1e-3)
            # a loop that amplifies f32 rounding: alive as x64 or as one
            # of JAX's own f32 runs, within 1e-3 of its band
            alive_ok = (a_i == cd["alive"]) if cd["f32_stable"] else \
                np.isin(a_i, [cd["alive"]] + cd["f32_alive"])
            good = bool(alive_ok.all()) and bool(
                (near if cd["f32_stable"] else near | inside).all())
            ok &= good or C != len(cands)
            rows.append(f"lasso {lval}: err_mean {e_i.mean():.6f} (x64 "
                        f"{cd['err_mean']:.6f}, f32 band {lo:.6f}-{hi:.6f}) "
                        f"alive {a_i.mean():.4f}")
        log(f"RN3 lasso sweep bilinear_iters={scfg.bilinear_iters} on the "
            f"six committed candidates, {C} lanes x {steps} steps: "
            f"{wall:.3f} s (CUDA events); " + "; ".join(rows) + f" | {smi}")
        if not ok:
            raise AssertionError("RN3 lasso sweep: off the JAX reference")
        out["launches"]["lasso_iters2" if C == len(cands)
                        else "lasso_iters2 full"] = counts["ipm_shared"]
        del res, ks
    took("RN3/RN4")

    # ---- RN5: the reference's per-step solve time at B=1
    for kind, sim in E.timed_sims.items():
        res = sim.run_trial_mpc_timed(blockM, steps=STEPS)
        ct = res["comp_time"] * 1e3
        log(f"RN5 run_trial_mpc_timed {kind} B=1 x {STEPS} steps on blockM: "
            f"comp_time mean {ct.mean():.4f} ms, median "
            f"{np.median(ct):.4f} ms, max {ct.max():.4f} ms (CUDA events "
            f"a step, a synchronize after it; {len(ct)} steps), err_mean "
            f"{res['err'].mean():.6f}, alive {bool(res['alive'].all())}; "
            f"the MATLAB reference's mean {MATLAB_COMP_MS[kind]} ms (one "
            f"CPU, BASELINE.md) | {smi}")
        if not (len(ct) == STEPS - 1 and np.isfinite(ct).all()
                and (ct > 0).all() and res["alive"].all()):
            raise AssertionError(f"RN5 {kind}: the timed run failed")
        out.setdefault("comp_time", {})[kind] = {
            "mean": float(ct.mean()), "median": float(np.median(ct)),
            "max": float(ct.max())}
    took("RN5")

    # ---- RN6: bilin_lift's del1 build on B_TAIL closed-loop lanes
    out["tail"] = del1_tail(D)
    took("RN6")
    for L in R.loops.values():
        L.arm.clear_graphs()
    R.arm_bench.clear_graphs()
    return out


KERNEL_DEF = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*"
                        r"|KG_BOUNDS\s+)?(\w+)\s*\(")


# ---- phase NU: the NMPC's unblocked stack (the default input_blocks=None,
# the reference's own NMPC: n = (Np-1) m = 27, mc = 108) in every route the
# JAX controller takes there, and loaded models with delays under the load
# observer; references by tests/test_torch_oracle.py
# --write-unblocked-refs and --write-loaded-delays
UNBLOCKED_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "nmpc_unblocked_refs.json"
LOADED_DEL_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "loaded_delays_refs.json"
# the routes' runs at full width, each path's route and kernel, the depth
# of the routes off the multipass one at B_GENERAL (cut to keep the phase
# near 3 minutes), the state-bound loop's lanes (the plain per-lane
# interior point) and the closed-loop steps of the kernel checks' lanes
NU_ROUTE_KERNEL = {"multipass": "nmpc_multipass", "stage": "nmpc_stage",
                   "chord": "nmpc_pass", "jacfwd": "nmpc_pass",
                   "linear": "ipm_factored", "state_bounds": None}
# (NU_STEPS: NU4's depth, cut from 21 to 11 when phase GN came)
NU_STEPS, NU_B_SB, NU_CHECK_STEPS, NU_B_CHECK = 11, 2048, (5, 40), 4096
# the loaded delayed loop's whole-batch err_mean against JAX f32's on the
# same 2048 lanes: its lanes are chaotic in f32 (JAX's own one-ulp copies
# span 0.20-0.58 a lane, the 16-lane mean's spread over them 0.017), so a
# 2048-lane mean moves by ~1.5e-3 (one sigma) between two f32 orderings;
# 5e-3 is three of them (as DX4 holds del1, PERF.md §6)
NU_LOADED_MEAN_TOL = 5e-3
# the reference lanes of every B=16 JAX run
REF_LANES = 16


def nu_setup(dev):
    """Phase NU's references, controllers (f32 and f64) of every path of
    ``UNBLOCKED_REFS`` and the loaded delayed model's, and the specs of
    its new builds: ``nmpc_multipass``, ``nmpc_stage`` (each mode),
    ``nmpc_pass`` (chord and jacfwd) and ``ipm_factored``'s q0 build at
    n=27, mc=108, and ``bilin`` at the loaded delayed NL."""
    import torch

    from koopman_realizations_torch.config import ArmConfig
    from koopman_realizations_torch.control.kmpc import (
        BilinearKmpc,
        NonlinearKmpc,
    )
    from koopman_realizations_torch.control.observer import (
        make_load_observer,
    )
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.ops import nmpc as N
    from koopman_realizations_torch.ops.kernels import bilin as BI
    from koopman_realizations_torch.ops.kernels import ipm_factored as IF
    from koopman_realizations_torch.ops.kernels import nmpc_multipass as NM
    from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
    from koopman_realizations_torch.ops.kernels import nmpc_stage as NS
    from koopman_realizations_torch.utils.checkpoint import (
        ASSETS,
        LOADED_DELAYED_MODEL,
        load_model,
    )
    from koopman_realizations_torch.utils.trajectories import (
        circle_reference,
    )
    refs = json.loads(UNBLOCKED_REFS.read_text())
    U = types.SimpleNamespace(refs=refs, ctl={}, ctl64={}, specs={})
    for name, p in refs["paths"].items():
        model, scaler, _ = load_model(ASSETS / p["asset"])
        cfg = rn_config(p["config"])
        for dt, ctl in ((torch.float32, U.ctl), (torch.float64, U.ctl64)):
            ctl[name] = NonlinearKmpc(model, scaler, cfg, device=dev,
                                      dtype=dt)
    q = U.ctl["default"].nmpc_qp()
    U.specs["nmpc_multipass"] = NM.kernel_spec(q)
    for mode in N.STAGE_MODES:
        U.specs[f"nmpc_stage {mode}"] = NS.kernel_spec(q, mode)
    U.specs["nmpc_pass chord"] = NP.kernel_spec(q)
    U.specs["nmpc_pass jacfwd"] = NP.kernel_spec(U.ctl["jacfwd"].nmpc_qp())
    lc = U.ctl["linear_update"]
    U.specs["ipm_factored q0"] = IF.kernel_spec(lc.constraints(), q.p,
                                                q0=True)
    # the loaded delayed loop (the loaded experiment's controller and
    # observer on the delayed asset)
    lrefs = json.loads(LOADED_DEL_REFS.read_text())
    lrec = json.loads(LOADED_REFS.read_text())
    model, scaler, _ = load_model(LOADED_DELAYED_MODEL)
    lcfg = rn_config(lrefs["mpc"])
    U.loaded = types.SimpleNamespace(
        refs=lrefs, r=lrec["recipe"], model=model, ref=circle_reference(),
        arm=Arm(ArmConfig(**lrec["recipe"]["arm"]), device=dev),
        ctl={dt: BilinearKmpc(model, scaler, lcfg, device=dev, dtype=dt)
             for dt in (torch.float32, torch.float64)},
        obs=make_load_observer(model, lcfg, device=dev))
    U.specs["bilin del1"] = BI.kernel_spec(
        U.loaded.ctl[torch.float32].bilin_qp())
    return U


def nu_launches(m, steps: int) -> dict:
    """The kernels' launches of a ``steps``-step run of an unblocked
    NMPC controller: one multipass launch a step, or one launch a pass on
    its route's kernel; none on the state-bound route (plain)."""
    k = NU_ROUTE_KERNEL[m.route]
    if k is None:
        return {}
    return {k: (steps - 1) * (1 if m.route == "multipass"
                              else m.cfg.sqp_iters)}


def nu_lane_gate(e, jr: dict):
    """DX's lane gate (``dict_lane_gate``) of a phase NU loop's 16
    reference lanes (the first 16 of ``e``): JAX x64's err_mean and the
    band of JAX's f32 runs, its one-ulp copies where the loop amplifies
    f32 rounding ("f32_copies"), else its one reading ("f32")."""
    import numpy as np
    copies = jr["f32_copies"] if "f32_copies" in jr else [jr["f32"]]
    f32 = np.asarray([[v for _, v in c] for c in copies])
    r = {"err_mean": jr["err_mean"],
         "f32": {"band": np.stack([f32.min(0), f32.max(0)], 1)}}
    return dict_lane_gate(e, r)


def nu_lanes(B: int, spread):
    """X0 of a phase NU run of B lanes whose first 16 are the reference
    lanes (``spread(16)``), the rest spread(B - 16)."""
    import numpy as np
    return np.concatenate([spread(REF_LANES), spread(B - REF_LANES)])


def phase_unblocked(dev, E, U, smi) -> dict:
    """Phase NU (ROADMAP items 4 and 7): the NMPC's default unblocked
    stack and its state bounds, and loaded models with delays.

    NU1 runs the default configuration (multipass, n=27) at B=65536 x 301
    through ``nmpc_multipass``, its first 16 lanes the reference lanes:
    alive 1.0 where JAX x64 keeps them alive, err_mean, wall and ms a
    launch.  NU2 holds each new build to its plain f32 and f64 versions
    on the first NU_B_CHECK of those lanes after 5 and 40 closed-loop steps
    (median and p99 distance to f64 within twice plain f32's, equal ok
    masks), cold at both and warm after 40: ``nmpc_multipass``,
    ``nmpc_stage`` in each mode, ``nmpc_pass`` with fresh Jacobians
    (chord) and forward-mode ones (jacfwd, the fourier_sparser model),
    ``ipm_factored``'s q0 build on the 'linear' update's QP; then times
    each at B=65536 beside its bound and plain version.  NU3 runs the 16
    reference lanes of the other routes over 301 steps through their
    kernels.  Every configuration's 16 lanes are held to the JAX
    references (NU1, NU3, NU5): alive equal, err_mean within 1e-3 of the
    hull of JAX x64 and JAX f32 lane by lane (``nu_lane_gate``: where the
    loop amplifies f32 rounding, JAX's 96-copy band, at most two lanes of
    a band wider than 1e-2 off by less than its width).  NU4 runs the
    routes off the multipass one at B=65536 over NU_STEPS steps (alive
    1.0, or no more lanes lost than the route's plain f32 version loses on
    the same lanes).  NU5 runs the state-bound loop (the plain per-lane
    interior point) at NU_B_SB lanes over its references' steps (101:
    depth cut, ~0.2 s a step whatever the width), its first 16 lanes the
    reference lanes, and counts the lane-steps with a state-bound row active (must
    be > 0).  NU6 runs the loaded
    delayed loop with the observer at B_full x 301 on the circle: ``bilin``
    at its NL against its plain version after 14 steps, the 16 reference
    lanes against x64 and JAX's f32 band (``nu_lane_gate``), alive as
    JAX's, the whole batch at JAX f32's alive and within
    NU_LOADED_MEAN_TOL of its err_mean.  Returns each build's launches,
    error, times and bound for the kernels line."""
    import numpy as np
    import torch

    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.ops import nmpc as N
    from koopman_realizations_torch.ops.kernels import bilin as BI
    from koopman_realizations_torch.ops.kernels import ipm_factored as IF
    from koopman_realizations_torch.ops.kernels import nmpc_multipass as NM
    from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
    from koopman_realizations_torch.ops.kernels import nmpc_stage as NS
    from koopman_realizations_torch.ops.qp import ok_mask
    from koopman_realizations_torch.utils.metrics import lane_tracking_error
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    # each route's kernel module and wrapper stem (NU4's plain comparison)
    NU_PLAIN_SWAP = {"stage": (NS, "nmpc_stage"), "chord": (NP, "nmpc_pass"),
                     "jacfwd": (NP, "nmpc_pass"),
                     "linear": (IF, "ipm_factored")}

    t_phase = time.perf_counter()
    ref = blockM_reference()
    refs = U.refs["paths"]
    arm = E.arm
    base = U.ctl["default"]
    sims = {name: Ksim(arm, m, device=dev) for name, m in U.ctl.items()}
    wins = sims["default"].reference_windows(ref, STEPS)
    spread = lambda B: E.spread_X0(B)
    out = {"launches": {}, "builds": {}}
    stamps = {}

    def took(tag):
        stamps[tag] = time.perf_counter()
        E.log(f"{tag} took {stamps[tag] - t_phase:.1f} s into phase NU")

    # ---- NU1: the default configuration at full width through
    # nmpc_multipass, recording the solve's inputs for NU2's lanes
    B = B_GENERAL
    XG, WG = nu_lanes(B, spread), np.zeros((B, 2), np.float32)
    run = sims["default"].batched_runner(
        ref, steps=STEPS, record=("Yp", "alive", "zeta", "u_prev_sc"))
    sims["default"].batched_runner(ref, steps=3)(XG[:1024], WG[:1024])
    exp = nu_launches(base, STEPS)
    go, gwall, counts = E.drive(exp, lambda: run(XG, WG))
    eG = lane_tracking_error(go["Yp"], ref)
    aliveG = go["alive"][:, -1].float().mean().item()
    nm_launch_ms = 1e3 * gwall / (STEPS - 1)
    E.log(f"NU1 unblocked NMPC (default config: input_blocks=None, n=27, "
          f"mc=108; multipass) general runner B={B} steps={STEPS}: "
          f"{gwall:.3f} s, {B * (STEPS - 1) / gwall:.4e} lane-steps/s, "
          f"{nm_launch_ms:.2f} ms a step, alive {aliveG:.6f}, err_mean "
          f"{eG.mean():.6f}, err_worst {eG.max():.6f}, launches {counts} "
          f"| {smi}")
    jr = refs["default"]
    e16 = eG[:REF_LANES].cpu().numpy()
    ok16, off, loose = nu_lane_gate(e16, jr)
    E.log(f"NU1 default's 16 reference lanes: err_mean {e16.mean():.6f} "
          f"(JAX x64 {np.mean(jr['err_mean']):.6f}), max lane distance to "
          f"x64 {np.abs(e16 - jr['err_mean']).max():.3e}, outside the "
          f"x64/f32 hull {off.max():.3e}")
    if not (ok16 and (aliveG == 1.0 or not all(jr["alive"]))
            and np.array_equal(go["alive"][:REF_LANES, -1].cpu().numpy(),
                               np.asarray(jr["alive"]))):
        raise AssertionError("NU1: the unblocked NMPC is off the JAX "
                             "references or lost lanes at full width")
    out["launches"]["default"] = {"nmpc_multipass":
                                  counts["nmpc_multipass"]}
    lanes = {k: (go["zeta"][:, k].T.contiguous(),
                 go["u_prev_sc"][:, k].T.contiguous())
             for k in NU_CHECK_STEPS}
    del go
    took("NU1")

    # ---- NU2: every new build against its plain f32 and f64 versions
    def gate(label, res_k, res_p, x64, qp_cons, b, tag="NU2"):
        (xk, sk, lk), (xp, sp, lp) = res_k[:3], res_p[:3]
        okk = ok_mask(qp_cons, b, xk, sk, lk, 3e-3, 5e-2)[0]
        okp = ok_mask(qp_cons, b, xp, sp, lp, 3e-3, 5e-2)[0]
        lv = torch.tensor([0.5, 0.99], dtype=torch.float64, device=dev)
        ek = torch.quantile((xk.double() - x64).abs().amax(0), lv)
        ep = torch.quantile((xp.double() - x64).abs().amax(0), lv)
        dx = (xk - xp).abs().max().item()
        E.log(f"{tag} {label}: max|dx| {dx:.3e}; distance to f64 (median, "
              f"p99): kernel {ek[0]:.3e} {ek[1]:.3e}, plain f32 "
              f"{ep[0]:.3e} {ep[1]:.3e}; ok {int(okk.sum())}/"
              f"{int(okp.sum())} of {xk.shape[1]}")
        if not (torch.equal(okk, okp)
                and bool((ek <= 2 * ep + 1e-5).all())):
            raise AssertionError(f"{tag} {label}: the kernel disagrees "
                                 f"with its plain version")
        return dx

    def inputs(k, Bc, rho=0.1, f64=True):
        """The operands of one pass of every build at step k's lanes (the
        first Bc), f32 and f64: the multipass plan as the linearization
        plan, its rollout, the chord's fresh Jacobians, the jacfwd
        model's forward-mode ones, the 'linear' update's condensed W, v,
        x0 = Ul[m:], q0 = -2 rho Ul[m:], the plan's multipliers in row
        units as the warm start."""
        zeta, up = (t[:, :Bc].contiguous() for t in lanes[k])
        sq = wins[k]
        U_, sol = base.solve(zeta, up, sq)
        d = {}
        for dt, ctl in ((torch.float32, U.ctl), (torch.float64, U.ctl64)
                        )[:2 if f64 else 1]:
            c, cj, cl = (ctl[n] for n in ("default", "jacfwd",
                                          "linear_update"))
            q_ = c.nmpc_qp(c.RdT_t + rho * c.bsizes_t)
            Ud, z, u, r = (t.to(dt).contiguous() for t in (U_, zeta, up, sq))
            Z = N.rollout(q_, z, Ud)
            Zl, Fv = Z[:-1].contiguous(), Z[1:].contiguous()
            Jt, cv = N.stage_lin(q_, Zl, Ud, Fv=Fv)
            Zj = cj._rollout_full(z, Ud)
            Jj, cvj = cj.stage_lin(Zj[:-1], Ud, Fv=Zj[1:])
            qj = cj.nmpc_qp(cj.RdT_t + rho * cj.bsizes_t)
            ql = cl.nmpc_qp(cl.RdT_t + rho * cl.bsizes_t)
            W, v = N.condense(ql, Jt, cv, z, u, r)
            x0 = Ud[3:].contiguous()
            d[dt] = dict(
                qp=q_, qj=qj, ql=ql, zeta=z, up=u, sq=r, Ul=Ud, Zl=Zl, Fv=Fv,
                Jt=Jt, cv=cv, Jj=Jj.contiguous(), cvj=cvj.contiguous(),
                W=W.contiguous(), v=v.contiguous(), x0=x0,
                q0=(-2.0 * rho * x0).contiguous(),
                lam0=(sol.lam.to(dt) * q_.row[:, None]).contiguous(),
                b_eq=((cl.cF_t[:, None] - cl.F0_t @ u)
                      / cl.row[:, None]).contiguous(),
                cons=cl.constraints())
        return d

    iters = base.cfg.qp_iters
    sqp = (base.cfg.sqp_iters, base.hold0, iters)

    def calls(build, d, warm=False):
        """(kernel, plain) calls of one launch of ``build`` on d."""
        lam = d["lam0"] if warm else None
        tail = (d["zeta"], d["up"], d["sq"], d["x0"], d["q0"], lam, iters,
                1e-2)
        if build == "nmpc_multipass":
            a = (d["qp"], d["zeta"], d["up"], d["sq"], *sqp)
            fk, fp = NM.nmpc_multipass_cuda, NM.nmpc_multipass_plain
            kw = {}
        elif build.startswith("nmpc_stage"):
            mode = build.split()[1]
            a = (d["qp"], mode) + tail
            kw = {"ship": dict(Zl=d["Zl"], Ul=d["Ul"], Fv=d["Fv"]),
                  "roll": dict(Ul=d["Ul"]), "hold": {}}[mode]
            fk, fp = NS.nmpc_stage_cuda, NS.nmpc_stage_plain
        elif build.startswith("nmpc_pass"):
            jac = build.endswith("jacfwd")
            a = ((d["qj"], d["Jj"], d["cvj"]) if jac
                 else (d["qp"], d["Jt"], d["cv"])) + tail
            fk, fp, kw = NP.nmpc_pass_cuda, NP.nmpc_pass_plain, {}
        else:
            a = (d["cons"], d["ql"].rdiag, d["W"], d["v"], d["b_eq"],
                 d["x0"], d["lam0"] if warm else None, iters, 1e-2,
                 d["q0"])
            fk, fp, kw = IF.ipm_factored_cuda, IF.ipm_factored_plain, {}
        return (lambda: fk(*a, **kw)), (lambda: fp(*a, **kw))

    def check(build, d, warm, label):
        kc, pc = calls(build, d[torch.float32], warm)
        rk = kc()
        torch.cuda.synchronize()
        rp = pc()
        x64 = calls(build, d[torch.float64], warm)[1]()[0]
        d32 = d[torch.float32]
        if build == "ipm_factored q0":
            cons, b = d32["cons"], d32["b_eq"]
        else:
            q_ = d32["qj"] if build.endswith("jacfwd") else d32["qp"]
            cons, b = q_.cons, N.rhs(q_, d32["up"])
        return gate(f"{build} {'warm' if warm else 'cold'} {label}", rk, rp,
                    x64, cons, b)

    builds = ["nmpc_multipass"] + [f"nmpc_stage {m}" for m in N.STAGE_MODES] \
        + ["nmpc_pass chord", "nmpc_pass jacfwd", "ipm_factored q0"]
    for b_ in builds:
        E.log(f"NU2 {b_} (n=27, mc=108): ptxas {E.ptx(U.specs[b_])}")
    err = {b_: 0.0 for b_ in builds}
    for k in NU_CHECK_STEPS:
        d = inputs(k, NU_B_CHECK)
        for b_ in builds:
            for warm in ((False,) if b_ == "nmpc_multipass"
                         or k != NU_CHECK_STEPS[-1] else (False, True)):
                err[b_] = max(err[b_], check(
                    b_, d, warm, f"B={NU_B_CHECK} after {k} steps"))
        del d
    took("NU2 checks")
    # times at B=65536 on the step-5 lanes, beside each build's bound
    d = inputs(NU_CHECK_STEPS[0], B, f64=False)
    d32 = d[torch.float32]
    q_ = d32["qp"]
    lane_bytes = nbytes(d32["zeta"], d32["up"], d32["sq"], d32["x0"],
                        d32["q0"]) + 4 * B * (q_.n + 2 * q_.mc + 1)
    shared = nbytes(q_.rdiag, q_.CzS, q_.cFr, q_.F0r, q_.A, q_.Wd, q_.Wo)
    fmaps = nbytes(q_.A1, q_.A2, q_.a0, q_.G)
    ops = {"nmpc_multipass": nmpc_ops(q_, *sqp),
           "nmpc_stage hold": nmpc_onepass_ops(q_, "hold", iters, True,
                                               False),
           "nmpc_stage roll": nmpc_onepass_ops(q_, "roll", iters, True,
                                               False),
           "nmpc_stage ship": nmpc_onepass_ops(q_, "ship", iters, True,
                                               False),
           "nmpc_pass chord": nmpc_onepass_ops(q_, "jacobians", iters, True,
                                               False),
           "nmpc_pass jacfwd": nmpc_onepass_ops(d32["qj"], "jacobians",
                                                iters, True, False),
           "ipm_factored q0": gram_ops(
               (d32["W"] != 0).any(-1).reshape(-1).tolist(), q_.n) + q_.n
           + factored_tail_ops(d32["cons"], iters)}
    extra = {"nmpc_multipass": fmaps + nbytes(q_.Gup, q_.q0c),
             "nmpc_stage hold": fmaps, "nmpc_stage roll": fmaps
             + nbytes(d32["Ul"]),
             "nmpc_stage ship": nbytes(q_.A1, q_.G, d32["Zl"], d32["Ul"],
                                       d32["Fv"]),
             "nmpc_pass chord": nbytes(d32["Jt"], d32["cv"]),
             "nmpc_pass jacfwd": nbytes(d32["Jj"], d32["cvj"]),
             "ipm_factored q0": nbytes(d32["W"], d32["v"], d32["b_eq"])
             - nbytes(d32["zeta"], d32["up"], d32["sq"]) - shared
             + nbytes(d32["cons"].A, d32["cons"].Wd, d32["cons"].Wo,
                      d32["ql"].rdiag)}
    for b_ in builds:
        kc, pc = calls(b_, d32)
        kname = b_.split()[0]
        ms = E.kernel_ms(kname, kc, reps=3 if b_ == "nmpc_multipass" else 5,
                         build=f"unblocked {b_}")
        plain = cuda_ms(pc, reps=1, warmup=1)
        flops = ops[b_] * B
        bms, by = bound(flops, lane_bytes + shared + extra[b_])
        out["builds"][b_] = {"kernel": kname, "err": err[b_], "ms": ms,
                             "plain": plain, "bound": bms, "by": by}
        E.log(f"NU2 {b_} at B={B}: {ms:.4f} ms (plain {plain:.2f} ms, "
              f"bound {bms:.4f} ms by {by}, {flops / B:.0f} op/lane) | "
              f"{smi}")
    del d, d32, lanes
    took("NU2 times")

    # ---- NU3: the 16 reference lanes of the other routes, 301 steps
    X16, W16 = spread(REF_LANES), np.zeros((REF_LANES, 2), np.float32)
    for name, jr in refs.items():
        if name in ("default", "state_bounds"):      # NU1, NU5
            continue
        m = U.ctl[name]
        exp = nu_launches(m, STEPS)
        o, wall, counts = E.drive(
            exp, lambda: sims[name].batched_runner(ref, steps=STEPS)(
                X16, W16))
        e = lane_tracking_error(o["Yp"], ref).cpu().numpy()
        alive = o["alive"][:, -1].cpu().numpy()
        x64 = np.asarray(jr["err_mean"])
        ok16, off, loose = nu_lane_gate(e, jr)
        E.log(f"NU3 {name} ({m.route}) B=16 x {STEPS}: err_mean "
              f"{e.mean():.6f} (JAX x64 {x64.mean():.6f}), max lane "
              f"distance to x64 {np.abs(e - x64).max():.3e}, outside the "
              f"x64/f32 hull {off.max():.3e} ({len(jr.get('f32_copies', [0]))}"
              f" JAX f32 runs; lanes off by 1e-3 or more {loose.tolist()});"
              f" alive {alive.mean():.4f}; {wall:.2f} s; launches {counts}")
        if not (np.array_equal(alive, np.asarray(jr["alive"])) and ok16):
            raise AssertionError(f"NU3 {name}: off the JAX references")
        out["launches"][f"{name} B=16"] = counts
    took("NU3")

    # ---- NU4: the routes off the multipass one at full width
    for name in ("damping_decay", "linesearch", "jac_period",
                 "linear_update", "jacfwd"):
        m = U.ctl[name]
        runf = sims[name].batched_runner(ref, steps=NU_STEPS)
        exp = nu_launches(m, NU_STEPS)
        o, wall, counts = E.drive(exp, lambda: runf(XG, WG))
        e = lane_tracking_error(o["Yp"], ref[:NU_STEPS])
        a = o["alive"][:, -1].float().mean().item()
        E.log(f"NU4 {name} ({m.route}) B={B} steps={NU_STEPS}: "
              f"{wall:.3f} s, {1e3 * wall / (NU_STEPS - 1):.2f} ms a step,"
              f" alive {a:.6f}, err_mean {e.mean():.6f}, launches "
              f"{counts} | {smi}")
        if a != 1.0:
            # a loop that loses lanes: the same lanes with the route's
            # kernel swapped for its plain f32 version (outside ``drive``)
            # must lose at least as many -- f32 orderings each lose their
            # own lanes of a chaotic loop (the jacfwd route's)
            mod, fn = NU_PLAIN_SWAP[m.route]
            kern = getattr(mod, fn + "_cuda")
            setattr(mod, fn + "_cuda", getattr(mod, fn + "_plain"))
            try:
                op_ = runf(XG, WG)
            finally:
                setattr(mod, fn + "_cuda", kern)
            lost_k = int((~o["alive"][:, -1]).sum())
            lost_p = int((~op_["alive"][:, -1]).sum())
            E.log(f"NU4 {name}: lanes lost by the kernel {lost_k}, by its "
                  f"plain f32 version on the same lanes {lost_p}")
            if lost_k > lost_p:
                raise AssertionError(f"NU4 {name}: the kernel loses more "
                                     f"lanes than its plain version")
            del op_
        out["launches"][name] = counts
        del o
    took("NU4")

    # ---- NU5: the state-bound loop on the plain per-lane route
    sbm = U.ctl["state_bounds"]
    jr = refs["state_bounds"]
    sb_steps = jr["steps"]
    solve0 = sbm.solve
    seen = {"active": 0, "lane_steps": 0}
    nrows = sbm.n_con

    def counting(*a, **kw):
        Uo, sol = solve0(*a, **kw)
        act = (sol.lam[nrows:] > 1e-6 * sol.lam.abs().amax(0).clamp_min(
            1e-12)).any(0) & sol.ok
        seen["active"] += int(act.sum())
        seen["lane_steps"] += act.numel()
        return Uo, sol
    sbm.solve = counting
    try:
        Xs, Ws = nu_lanes(NU_B_SB, spread), np.zeros((NU_B_SB, 2),
                                                       np.float32)
        o, wall, counts = E.drive({}, lambda: sims["state_bounds"]
                                  .batched_runner(ref, steps=sb_steps)(Xs,
                                                                       Ws))
    finally:
        del sbm.solve
    e = lane_tracking_error(o["Yp"], ref[:sb_steps])
    a = o["alive"][:, -1].float().mean().item()
    E.log(f"NU5 state bounds (plain per-lane interior point, n=27, "
          f"mc={nrows + 2 * 6 * 9}) B={NU_B_SB} steps={sb_steps}: "
          f"{wall:.3f} s"
          f", alive {a:.6f}, err_mean {e.mean():.6f}; a state-bound row "
          f"active on {seen['active']} of {seen['lane_steps']} lane-steps "
          f"| {smi}")
    e16 = e[:REF_LANES].cpu().numpy()
    ok16, off, _ = nu_lane_gate(e16, jr)
    E.log(f"NU5 state bounds' 16 reference lanes: err_mean {e16.mean():.6f}"
          f" (JAX x64 {np.mean(jr['err_mean']):.6f}), max lane distance to "
          f"x64 {np.abs(e16 - jr['err_mean']).max():.3e}, outside the "
          f"x64/f32 hull {off.max():.3e}")
    if seen["active"] == 0 or not ok16 or (all(jr["alive"]) and a != 1.0):
        raise AssertionError("NU5: no state-bound row active, lanes lost "
                             "or off the JAX references")
    out["sb_active"] = seen
    took("NU5")

    # ---- NU6: the loaded delayed loop with the observer
    L = U.loaded
    lr = L.refs
    Bf = L.r["B_full"]
    X0, W = loaded_lanes(Bf, L.r)
    c32, c64 = L.ctl[torch.float32], L.ctl[torch.float64]
    lsim = Ksim(L.arm, c32, observer=L.obs, device=dev)
    st = lsim.batched_runner(L.ref, steps=15, record=(
        "Z", "u_prev_sc", "U_plan_in", "alive"))(X0, W)
    k = 13
    z = st["Z"][:, k].T.contiguous()
    up = st["u_prev_sc"][:, k].T.contiguous()
    Up = st["U_plan_in"][:, k].reshape(Bf, -1).T.contiguous()
    win = lsim.reference_windows(L.ref, 16)[k]
    a = {}
    for dt, c in ((torch.float32, c32), (torch.float64, c64)):
        a[dt] = (c.bilin_qp(), z.to(dt).contiguous(),
                 up.to(dt).contiguous(),
                 c.warm_start(Up.to(dt)).contiguous(), None,
                 win.to(dt).contiguous(), c.cfg.qp_iters, 1e-2)
    bq = a[torch.float32][0]
    rk = BI.bilin_cuda(*a[torch.float32])
    torch.cuda.synchronize()
    rp = BI.bilin_plain(*a[torch.float32])
    x64 = BI.bilin_plain(*a[torch.float64])[0]
    b = c32.cFr[:, None] - c32.F0r @ up
    berr = gate(f"bilin (loaded delayed, NL={bq.nzl}, n={bq.n}, mc={bq.mc})"
                f" cold B={Bf} after {k + 1} steps", rk, rp, x64,
                c32.constraints(), b, tag="NU6")
    bms_ = E.kernel_ms("bilin", lambda: BI.bilin_cuda(*a[torch.float32]),
                       reps=20, build="loaded delayed")
    bplain = cuda_ms(lambda: BI.bilin_plain(*a[torch.float32]), reps=3,
                     warmup=1)
    bflops = qp_ops(bq, c32.cfg.qp_iters) * Bf
    bb, bby = bound(bflops, nbytes(*a[torch.float32][1:4],
                                   a[torch.float32][5])
                    + 4 * Bf * (bq.n + 2 * bq.mc + 1)
                    + nbytes(bq.gens, bq.rdiag, bq.A, bq.cFr, bq.F0r,
                             bq.Wd, bq.Wo))
    E.log(f"NU6 bilin loaded delayed NL={bq.nzl} at B={Bf}: {bms_:.4f} ms "
          f"(plain {bplain:.2f} ms, bound {bb:.5f} ms by {bby}); ptxas: "
          f"{E.ptx(U.specs['bilin del1'])} | {smi}")
    del st
    steps_l = lr["steps"]
    exp = {"bilin": steps_l - 1,
           "ipm_shared": sum(1 for kk in range(1, steps_l)
                             if L.obs.updates(kk))}
    o, wall, counts = E.drive(exp, lambda: lsim.batched_runner(
        L.ref, steps=steps_l)(X0, W))
    Yp = o["Yp"]
    e = torch.sqrt(((Yp - torch.as_tensor(L.ref[:steps_l - 1], device=dev,
                                          dtype=Yp.dtype)) ** 2).sum(-1)
                   ).mean(1).cpu().numpy()
    alive = o["alive"][:, -1].cpu().numpy()
    nref = lr["B"]
    lanes_ok, far, _ = nu_lane_gate(e[:nref], {
        "err_mean": lr["err_mean"], "f32_copies": lr["f32_copies"]})
    wh = o["what"]
    full = lr["full_f32"]
    E.log(f"NU6 loaded delayed loop (nzeta {L.model.meta.nzeta}, NL "
          f"{L.model.meta.NL}) with the observer B={Bf} x {steps_l}: "
          f"{wall:.3f} s, alive {alive.mean():.6f} (JAX f32 "
          f"{full['alive']:.6f}), err_mean {e.mean():.6f} (JAX f32 "
          f"{full['err_mean']:.6f}); 16 reference lanes: err_mean "
          f"{e[:nref].mean():.6f} (JAX x64 {np.mean(lr['err_mean']):.6f}), "
          f"outside the x64/f32-band hull {far.max():.3e}; What in "
          f"[{wh.min().item():.3f}, {wh.max().item():.3f}]; launches "
          f"{counts} | {smi}")
    fails = [name for name, ok in (
        ("alive of the reference lanes",
         np.array_equal(alive[:nref], np.asarray(lr["alive"]))),
        ("reference lanes off the hull", lanes_ok),
        ("alive fraction", abs(alive.mean() - full["alive"])
         < 1e-9 + 1.0 / Bf),
        ("err_mean", abs(e.mean() - full["err_mean"]) < NU_LOADED_MEAN_TOL),
        ("What outside [-1, 1]", wh.abs().max().item() <= 1.0 + 1e-6))
        if not ok]
    if fails:
        raise AssertionError(f"NU6: the loaded delayed loop is off the JAX "
                             f"references: {fails}")
    out["builds"]["bilin del1"] = {"kernel": "bilin", "err": berr,
                                   "ms": bms_, "plain": bplain, "bound": bb,
                                   "by": bby}
    out["launches"]["loaded delayed"] = counts
    took("NU6")
    marks = [t_phase] + list(stamps.values())
    E.log("NU phase times (s): " + ", ".join(
        f"{tag} {b - a:.1f}" for tag, a, b in zip(stamps, marks, marks[1:]))
        + f"; total {time.perf_counter() - t_phase:.1f}")
    return out


# ---- phase GN: the arm plant in full and data generation without JAX
# GN2's generator at full width: the corpus arm's excitation trials (tf
# cut from the corpus's 60 s to 10 s, 201 samples, for the time limit)
GN_TRIALS, GN_TF = 65536, 10.0
# GN4: the JAX x64 general runner on the arm's other plants (written by
# tests/test_torch_oracle.py --write-plants); their full-width loops
# at B_GENERAL, the 'rk45' one cut to GN_RK45_STEPS steps
PLANT_REFS = ROOT / "koopman_realizations_torch" / "assets" / \
    "plant_refs.json"
GN_RK45_STEPS = 21
# GN4's gate on each of the 16 reference lanes' err_mean against JAX x64
# (measured within 4.6e-6 in f32 on an H100); the 16-lane mean within 1e-3
GN4_LANE_TOL = 1e-4
# GN5: the stage-wise LQ solvers on the linear asset's (A, B)
GN5_B, GN5_NP, GN5_NP_SHORT, GN5_CPU_LANES = 4096, 200, 10, 16


def lq_problem(A, B, Np: int, lanes: int, seed: int = 0) -> tuple:
    """A seeded LQ tracking problem on (A, B), f64 numpy: diagonal state
    costs (terminal x10), diagonal input costs, small linear terms, and
    ``lanes`` initial states z0 (lanes, n)."""
    import numpy as np
    n, m = B.shape
    rng = np.random.default_rng(seed)
    Qs = np.tile(np.diag(rng.uniform(0.1, 1.0, n))[None], (Np + 1, 1, 1))
    Qs[-1] *= 10.0
    Rs = np.tile(np.diag(rng.uniform(0.1, 0.5, m))[None], (Np, 1, 1))
    qs = 0.1 * rng.normal(size=(Np + 1, n))
    rs = 0.01 * rng.normal(size=(Np, m))
    return (np.asarray(A, float), np.asarray(B, float), Qs, Rs, qs, rs,
            rng.normal(size=(lanes, n)))


def lq_condensed(A, B, Qs, Rs, qs, rs, z0):
    """The dense equivalent of one LQ problem (``tests/test_riccati.py:
    _condense``): J(U) = 1/2 U'P U + f'U, numpy f64."""
    import numpy as np
    n, m = B.shape
    Np = Rs.shape[0]
    powers = [np.eye(n)]
    for _ in range(Np):
        powers.append(powers[-1] @ A)
    Abig = np.concatenate(powers, axis=0)
    Bbig = np.zeros((n * (Np + 1), m * Np))
    for i in range(1, Np + 1):
        for j in range(i):
            Bbig[i * n:(i + 1) * n, j * m:(j + 1) * m] = powers[i - 1 - j] @ B
    Qblk = np.zeros((n * (Np + 1), n * (Np + 1)))
    for k in range(Np + 1):
        Qblk[k * n:(k + 1) * n, k * n:(k + 1) * n] = Qs[k]
    Rblk = np.zeros((m * Np, m * Np))
    for k in range(Np):
        Rblk[k * m:(k + 1) * m, k * m:(k + 1) * m] = Rs[k]
    P = Bbig.T @ Qblk @ Bbig + Rblk
    f = Bbig.T @ (Qblk @ (Abig @ z0) + qs.reshape(-1)) + rs.reshape(-1)
    return P, f


def phase_generation(dev, E, smi) -> dict:
    """Phase GN: the arm plant in full and data generation without JAX.

    GN1 regenerates the three committed corpora on the card in f64
    (``workflows/arm_data.py:corpus``: the markers and angle corpora of
    ``generate(15, 60.0, n_val=5, seed=0)``, the loaded one's 16 loads
    from seed 7) and holds them trial by trial to the files the JAX
    package wrote: t, u and w bitwise, y within 1e-8.  GN2 runs the
    generator (``simulate_rampNhold_batch``) at GN_TRIALS trials of the
    corpus arm (tf cut to GN_TF), all four outputs, wall time and
    trial-steps/s, 16 trials held to the CPU's eager f64 plant within
    1e-10, the PlantGraph's period and memory pool.  GN3 takes GN1's
    corpus through ``save_data4sysid`` / ``load_data4sysid``, trains the
    main path's bilinear model on the card (one-step within 1.2e-7 of the
    asset's), drives ``Ksim.fused_runner`` with it at B_MAIN x 301 (alive
    1.0, err_mean within 1e-3 of the asset header's) and reads its
    ``export_mat`` back.  GN4 holds each new plant's graph to its eager
    period (bitwise), then runs the main bilinear
    controller in the general runner (``bilin_lift``) on it: 'rk4' and
    'stage' at B_GENERAL x 301, the first 16 lanes the reference lanes
    (each lane's err_mean within GN4_LANE_TOL of ``plant_refs.json``,
    their mean within 1e-3, alive equal; all alive), 'rk45'
    on the 16 lanes x 301 and at B_GENERAL x GN_RK45_STEPS (alive 1.0).
    GN5 holds ``solve_lq_stagewise`` / ``solve_lq_box_barrier`` at
    Np=GN5_NP on GN5_B initial states of the linear asset to the CPU in
    f64, at Np=GN5_NP_SHORT to the condensed QP, and ``batch_linalg`` at
    n = 6, 12, 27 to the CPU.  Any miss raises.  Returns the launches of
    the kernels on the phase's paths and its times."""
    import dataclasses

    import numpy as np
    import scipy.io as sio
    import torch

    from koopman_realizations_torch.config import (
        ArmConfig,
        MpcConfig,
        SysidConfig,
    )
    from koopman_realizations_torch.control.kmpc import BilinearKmpc
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.arm import OUTPUTS, RK45_CHUNK, Arm
    from koopman_realizations_torch.models.edmd import Ksysid
    from koopman_realizations_torch.ops import batch_linalg as BLA
    from koopman_realizations_torch.ops import riccati as RIC
    from koopman_realizations_torch.ops.kernels._build import BUILD
    from koopman_realizations_torch.ops.qp import solve_qp_lane_A
    from koopman_realizations_torch.utils.checkpoint import (
        BENCH_MODEL,
        LINEAR_MODEL,
        export_mat,
        load_model,
    )
    from koopman_realizations_torch.utils.matio import (
        load_data4sysid,
        save_data4sysid,
    )
    from koopman_realizations_torch.utils.metrics import (
        lane_tracking_error,
        one_step_predictions,
    )
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    from koopman_realizations_torch.workflows.arm_data import (
        ASSETS,
        CORPORA,
        CORPUS_ARM,
        corpus,
        corpus_distance,
    )
    log, drive = E.log, E.drive
    t_phase = [time.perf_counter()]
    times, launches = {}, {"step_fused": 0, "bilin_lift": 0}

    def took(tag):
        now = time.perf_counter()
        times[tag] = now - t_phase[0]
        log(f"{tag} took {times[tag]:.1f} s")
        t_phase[0] = now

    def sync_wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- GN1: the three committed corpora, regenerated on the card
    gen = {}
    for name, r in CORPORA.items():
        ds, wall = sync_wall(lambda: corpus(name, device=dev))
        d = corpus_distance(ds, ASSETS / r["file"])
        T = ds.train[0].T
        log(f"GN1 corpus {name} ({r['file']}) regenerated on the card in "
            f"f64: {d['trials']} trials x {T} samples in {wall:.2f} s "
            f"(plant graph capture included); t bitwise {d['t_equal']}, u "
            f"bitwise {d['u_equal']}, w bitwise {d['w_equal']}, y max abs "
            f"{d['y_max']:.3e} (gate 1e-8) | {smi}")
        if not (d["trials_equal"] and d["t_equal"] and d["u_equal"]
                and d["w_equal"] and d["y_max"] < 1e-8):
            raise AssertionError(f"GN1 {name}: the port's corpus is not "
                                 f"the committed one")
        gen[name] = ds
    took("GN1")

    # ---- GN2: the generator at full width
    cfg = ArmConfig(**CORPUS_ARM)
    garm = Arm(cfg, device=dev)
    sims, wall = sync_wall(lambda: garm.simulate_rampNhold_batch(
        np.random.default_rng(0), tf=GN_TF, Tramp=2.5,
        W=np.zeros((GN_TRIALS, 2))))
    T = len(sims[0]["t"])
    X = np.stack([s["x"] for s in sims])                  # (B, T, nx)
    finite = bool(np.isfinite(X).all())
    Xd = torch.as_tensor(X.reshape(-1, cfg.nx), device=dev)
    idx = np.linspace(0, GN_TRIALS - 1, REF_LANES).astype(int)
    shapes = {}
    for ot in OUTPUTS:
        a = Arm(dataclasses.replace(cfg, output_type=ot), device=dev)
        Y = a.get_y_batch(Xd).reshape(GN_TRIALS, T, -1)
        finite &= bool(torch.isfinite(Y).all())
        shapes[ot] = tuple(Y.shape)
        if ot == cfg.output_type:
            same_y = np.array_equal(Y[idx].cpu().numpy(),
                                    np.stack([sims[b]["y"] for b in idx]))
        del Y
    del Xd
    carm = Arm(cfg, device="cpu")
    Uc = torch.from_numpy(np.stack([sims[b]["u"][:-1] for b in idx], 2))
    Xc = carm._roll(torch.zeros((cfg.nx, REF_LANES), dtype=torch.float64),
                    Uc, torch.zeros((2, REF_LANES), dtype=torch.float64))
    d_cpu = float(np.abs(Xc.permute(2, 0, 1).numpy() - X[idx]).max())
    Yc = carm.get_y(Xc.permute(1, 0, 2).reshape(cfg.nx, -1))
    d_ycpu = float(np.abs(Yc.reshape(-1, T, REF_LANES).permute(2, 1, 0)
                          .numpy() - np.stack([sims[b]["y"] for b in idx]))
                   .max())
    # the period's graph: a fresh capture's pool, and its replay time
    garm.clear_graphs()
    Xp = torch.as_tensor(X[:, T // 2].T.copy(), device=dev)
    Up = torch.as_tensor(np.stack([s["u"][T // 2] for s in sims], 1),
                         device=dev)
    Wp = torch.zeros((2, GN_TRIALS), dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved(dev)
    garm.step(Xp, Up, Wp)
    pool = (torch.cuda.memory_reserved(dev) - r0) / 2 ** 20
    period = cuda_ms(lambda: garm.step(Xp, Up, Wp), reps=5)
    garm.clear_graphs()
    rate = GN_TRIALS * (T - 1) / wall
    log(f"GN2 simulate_rampNhold_batch B={GN_TRIALS} trials x {T} samples "
        f"(tf {GN_TF} s, cut from 60 s) of the corpus arm in f64 (SDIRK2 "
        f"'substep', 5 substeps, 3 Newton iterations): {wall:.2f} s wall "
        f"(host tables and copies included), {rate:.4e} trial-steps/s; "
        f"outputs {shapes}, all finite {finite}, the 16 trials' y "
        f"get_y_batch's {same_y}; the 16 trials against the CPU's eager f64 "
        f"plant: x max abs {d_cpu:.3e}, y {d_ycpu:.3e} (gate 1e-10); its "
        f"PlantGraph period {period:.3f} ms at B={GN_TRIALS} f64, pool "
        f"{pool:.1f} MiB | {smi}")
    if not (finite and same_y and d_cpu < 1e-10 and d_ycpu < 1e-10):
        raise AssertionError("GN2: the full-width generator is off")
    times["GN2_wall"], times["GN2_period_ms"] = wall, period
    del sims, X
    took("GN2")

    # ---- GN3: generate -> .mat -> train -> control, without JAX
    ds = gen["markers"]
    mat = BUILD / "generated" / "arm3_corpus.mat"
    mat.parent.mkdir(parents=True, exist_ok=True)
    save_data4sysid(str(mat), ds)
    back = load_data4sysid(str(mat))
    same = all(np.array_equal(getattr(a, f), getattr(b, f))
               for sa, sb in ((ds.train, back.train), (ds.val, back.val))
               for a, b in zip(sa, sb) for f in ("t", "y", "u", "x"))
    ks = Ksysid(back, SysidConfig(model_type="bilinear",
                                  pca_explained=PCA_EXPLAINED["bilinear"],
                                  **TRAIN_RECIPE), device=dev).train_models()
    am, asc, header = load_model(BENCH_MODEL)
    jr = header["jax_reference"]
    d_asset = float(np.abs(one_step_predictions(ks.model, ks.valdata, dev)
                           - one_step_predictions(am, ks.valdata,
                                                  dev)).max())
    barm = Arm(ArmConfig(**ARM), device=dev)
    sim = Ksim(barm, BilinearKmpc(ks.model, ks.scaler, MpcConfig(**MPC),
                                  device=dev), device=dev)
    ref = blockM_reference()
    run = sim.fused_runner(ref, steps=STEPS)
    XB = E.spread_X0(B_MAIN)
    WB = np.zeros((B_MAIN, 2), np.float32)
    run(XB[:1024], WB[:1024])                       # warm-up (allocator)
    out, fwall, _ = drive({"step_fused": STEPS - 1}, lambda: run(XB, WB))
    launches["step_fused"] += STEPS - 1
    alive = out["alive"][:, -1].float().mean().item()
    e = lane_tracking_error(out["Yp"], ref)
    del out
    exp = sio.loadmat(export_mat(str(BUILD / "generated" / "bilinear"),
                                 ks.model))["model"][0, 0]
    NL, m = ks.model.A.shape[0], ks.model.meta.m
    exported = (np.array_equal(exp["A"], ks.model.A)
                and np.array_equal(exp["C"], ks.model.C)
                and np.array_equal(exp["B"], ks.model.B.reshape(NL, m * NL)))
    log(f"GN3 generated corpus -> save_data4sysid -> load_data4sysid "
        f"(trials bitwise {same}) -> Ksysid bilinear poly-3 PCA on the card "
        f"(NL {NL}, one-step max abs {d_asset:.3e} from the asset, gate "
        f"1.2e-7) -> fused_runner B={B_MAIN} x {STEPS}: {fwall:.3f} s, "
        f"alive {alive:.6f}, err_mean {e.mean():.6f} (asset header "
        f"{jr['err_mean']:.6f}, gate 1e-3); export_mat read back by scipy "
        f"(A, B (NL, m NL), C bitwise) {exported} | {smi}")
    if not (same and d_asset < 1.2e-7 and alive == 1.0
            and abs(e.mean().item() - jr["err_mean"]) < 1e-3 and exported):
        raise AssertionError("GN3: generate -> train -> control is off")
    times["GN3_fused_s"] = fwall
    took("GN3")

    # ---- GN4: the new plants in the closed loop (bilin_lift)
    refs = json.loads(PLANT_REFS.read_text())
    model, scaler, _ = load_model(BENCH_MODEL)
    mpc = BilinearKmpc(model, scaler, MpcConfig(**MPC), device=dev)
    W16 = np.zeros((REF_LANES, 2), np.float32)
    WG = np.zeros((B_GENERAL, 2), np.float32)
    XG = np.concatenate([E.spread_X0(REF_LANES),
                         E.spread_X0(B_GENERAL - REF_LANES)])
    plants = {}
    for name, r in refs["plants"].items():
        parm = Arm(ArmConfig(**r["arm"]), device=dev)
        # the graphed period against the eager one, bitwise over two
        # periods, at full width
        Xl, Ul, Wl = plant_lanes(parm, B_GENERAL)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved(dev)
        xg = parm.step(Xl, Ul, Wl)
        pool = (torch.cuda.memory_reserved(dev) - r0) / 2 ** 20
        rk45 = parm.cfg.integrator == "rk45"
        gkey = (B_GENERAL, torch.float32, Xl.device)
        replays = getattr(parm._graphs.get(gkey), "replays", None)
        xe, t_eager = sync_wall(lambda: parm.step_eager(Xl, Ul, Wl))
        t_eager *= 1e3
        graphed = torch.equal(xe.view(torch.int32), xg.view(torch.int32))
        t_full = cuda_ms(lambda: parm.step(Xl, Ul, Wl), reps=3, warmup=1)
        X16, U16, W16l = (t[:, :REF_LANES].contiguous() for t in (Xl, Ul, Wl))
        t_16 = cuda_ms(lambda: parm.step(X16, U16, W16l), reps=3, warmup=1)
        sim = Ksim(parm, mpc, device=dev)
        full_steps = GN_RK45_STEPS if rk45 else STEPS
        if rk45:
            o16, w16, _ = drive({"bilin_lift": STEPS - 1}, lambda: sim
                                .batched_runner(ref, steps=STEPS)(
                                    E.spread_X0(REF_LANES), W16))
            launches["bilin_lift"] += STEPS - 1
        og, wg, _ = drive({"bilin_lift": full_steps - 1}, lambda: sim
                          .batched_runner(ref, steps=full_steps)(XG, WG))
        launches["bilin_lift"] += full_steps - 1
        if not rk45:
            o16 = {k: v[:REF_LANES] for k, v in og.items()}
            w16 = wg
        e16 = lane_tracking_error(o16["Yp"], ref)
        a16 = o16["alive"][:, -1].cpu().numpy()
        aliveG = og["alive"][:, -1].float().mean().item()
        d_mean = abs(e16.mean().item() - float(np.mean(r["err_mean"])))
        d_lane = float(np.abs(e16.double().cpu().numpy()
                              - np.asarray(r["err_mean"])).max())
        plants[name] = dict(period_ms=t_full, period_eager_ms=t_eager,
                            period_16_ms=t_16, pool_mib=pool,
                            loop16_s=w16, full_s=wg, full_steps=full_steps,
                            err_mean=e16.mean().item(), d_mean=d_mean,
                            d_lane=d_lane)
        log(f"GN4 plant {name} ({r['arm']}): graph bitwise the eager period "
            f"{graphed}; a period {t_full:.3f} ms replayed "
            f"at B={B_GENERAL} ({t_eager:.1f} ms eager), {t_16:.3f} ms at "
            f"B=16, pool {pool:.1f} MiB"
            + (f", {replays} replays of RK45Graph's {RK45_CHUNK}-iteration "
               f"chunk in the period" if rk45 else "")
            + f"; 16 lanes x {STEPS}: err_mean {e16.mean():.6f} (JAX x64 "
            f"{np.mean(r['err_mean']):.6f}, |d| {d_mean:.3e}, gate 1e-3; "
            f"each lane's |d| at most {d_lane:.3e}, gate {GN4_LANE_TOL}), "
            f"alive as JAX {bool((a16 == np.asarray(r['alive'])).all())} "
            f"({w16:.1f} s); B={B_GENERAL} x {full_steps}: alive "
            f"{aliveG:.6f} in {wg:.1f} s | {smi}")
        if not (graphed and d_mean < 1e-3 and d_lane < GN4_LANE_TOL
                and (a16 == np.asarray(r["alive"])).all()
                and aliveG == 1.0):
            raise AssertionError(f"GN4 {name}: the plant's loop is off")
        parm.clear_graphs()
        del og, o16
        took(f"GN4 {name}")

    # ---- GN5: riccati and batch_linalg on the card, held to the CPU in f64
    lmodel = load_model(LINEAR_MODEL)[0]
    t64 = lambda a, d=dev: torch.as_tensor(a, dtype=torch.float64, device=d)
    prob = lq_problem(lmodel.A, lmodel.B, GN5_NP, GN5_B)
    shared, z0 = prob[:6], prob[6]
    (Uc, Zc), sw_s = sync_wall(lambda: RIC.solve_lq_stagewise(
        *(t64(a) for a in shared), t64(z0)))
    (Ub, okb), bb_s = sync_wall(lambda: RIC.solve_lq_box_barrier(
        *(t64(a) for a in shared), t64(z0), -0.6, 0.6))
    sub = slice(0, GN5_CPU_LANES)
    Uh, _ = RIC.solve_lq_stagewise(*(t64(a, "cpu") for a in shared),
                                   t64(z0[sub], "cpu"))
    Ubh, okh = RIC.solve_lq_box_barrier(*(t64(a, "cpu") for a in shared),
                                        t64(z0[sub], "cpu"), -0.6, 0.6)
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    d_sw, d_bb = rel(Uc[sub], Uh), rel(Ub[sub], Ubh)
    active = float((Ub.abs() > 0.6 - 1e-2).float().mean())
    # Np = 10: against the condensed QP
    pS = lq_problem(lmodel.A, lmodel.B, GN5_NP_SHORT, 8, seed=1)
    Us, _ = RIC.solve_lq_stagewise(*(t64(a) for a in pS[:6]), t64(pS[6]))
    Ubs, oks = RIC.solve_lq_box_barrier(*(t64(a) for a in pS[:6]),
                                        t64(pS[6]), -0.6, 0.6,
                                        outer_iters=16, newton_iters=2)
    d_dense, d_qp = 0.0, 0.0
    nU = GN5_NP_SHORT * lmodel.B.shape[1]
    Abox = np.concatenate([np.eye(nU), -np.eye(nU)])
    Pd, fd = zip(*(lq_condensed(*pS[:6], z) for z in pS[6]))
    for p, (P, f) in enumerate(zip(Pd, fd)):
        d_dense = max(d_dense, float(np.abs(
            Us[p].cpu().numpy().reshape(-1) - np.linalg.solve(P, -f)).max()))
    lanes = len(Pd)
    sol = solve_qp_lane_A(
        t64(np.stack(Pd, -1), "cpu"), t64(np.stack(fd, -1), "cpu"),
        t64(np.repeat(Abox[..., None], lanes, -1), "cpu"),
        t64(np.full((2 * nU, lanes), 0.6), "cpu"), iters=30)
    d_qp = float(np.abs(Ubs.cpu().numpy().reshape(lanes, -1)
                        - sol.x.T.numpy()).max())
    qp_ok = bool(sol.ok.all())
    # batch_linalg at n = 6, 12, 27 (the arm's SDIRK2 normal equations,
    # the controllers' decision sizes)
    # each distance over the unit roundoff times the condition number of
    # the system it solves (M's; A's squared for the normal equations)
    g = torch.Generator().manual_seed(0)
    bl = {}
    eps = torch.finfo(torch.float64).eps
    for n in (6, 12, 27):
        Gm = torch.randn((GN5_B, n, n), generator=g, dtype=torch.float64)
        M = Gm @ Gm.transpose(1, 2) + n * torch.eye(n, dtype=torch.float64)
        A_ = torch.randn((GN5_B, n, n), generator=g, dtype=torch.float64) \
            + 3 * torch.eye(n, dtype=torch.float64)
        b = torch.randn((GN5_B, n), generator=g, dtype=torch.float64)
        kM = float(torch.linalg.cond(M).max())
        kA = float(torch.linalg.cond(A_).max()) ** 2
        d = 0.0
        for fn, args, k in ((BLA.chol_unrolled, (M,), kM),
                            (BLA.solve_spd_unrolled, (M, b), kM),
                            (BLA.solve_via_normal_unrolled, (A_, b), kA)):
            ref_ = fn(*args)
            d = max(d, rel(fn(*(a.to(dev) for a in args)), ref_) / (eps * k))
        bl[n] = d
    log(f"GN5 riccati on the linear asset's (A, B) (n={lmodel.A.shape[0]}, "
        f"m={lmodel.B.shape[1]}), Np={GN5_NP}, B={GN5_B} initial states, "
        f"f64: solve_lq_stagewise {sw_s:.3f} s, solve_lq_box_barrier "
        f"{bb_s:.3f} s (ok {bool(okb.all())}, {active:.3f} of the inputs "
        f"within 1e-2 of a bound), {GN5_CPU_LANES} lanes against the CPU: "
        f"max rel {d_sw:.3e} / {d_bb:.3e} (gate 1e-9); Np={GN5_NP_SHORT} "
        f"against the condensed QP: unconstrained max abs {d_dense:.3e} "
        f"(gate 1e-8), boxed vs the plain interior point {d_qp:.3e} (gate "
        f"5e-3, QP ok {qp_ok}); batch_linalg on the card vs the CPU, max "
        f"rel over eps x the system's condition number " + ", ".join(
            f"n={n} {v:.3e}" for n, v in bl.items()) + f" (gate 10) | {smi}")
    if not (bool(okb.all()) and bool(okh.all()) and bool(oks.all())
            and d_sw < 1e-9 and d_bb < 1e-9 and d_dense < 1e-8
            and qp_ok and d_qp < 5e-3 and max(bl.values()) < 10):
        raise AssertionError("GN5: riccati / batch_linalg off the CPU")
    took("GN5")
    log("GN phase times (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items() if k.startswith("GN")
        and not k.endswith(("_ms", "_s", "_wall"))))
    return {"launches": launches, "times": times, "plants": plants}


def kernel_names(csrc: Path) -> frozenset:
    """The names of the port's kernels, from its CUDA sources."""
    return frozenset(name for src in csrc.glob("*.cu")
                     for name in KERNEL_DEF.findall(src.read_text()))


def open_profile_window():
    """Launch a fill kernel and wait for it: the first thing in a
    torch.profiler window.  The profiler drops the first kernel of its
    window (on the H100, one of three calls' first launches went missing),
    so this one goes instead of one of the kernels measured."""
    import torch
    torch.empty(1, device="cuda").fill_(1.0)
    torch.cuda.synchronize()


def device_events(fn, calls: int) -> dict:
    """{kernel: (device ms a call, launches a call)} over ``calls`` calls
    of fn after one outside the window, from torch.profiler (the kernel's
    name without its arguments); empty where the profiler recorded no
    device time.  A fill kernel opens the window and another closes it,
    so that neither end of the window is one of fn's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_profile_window()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        open_profile_window()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            key = e.key.split("(")[0].split()[-1]
            ms, n = out.get(key, (0.0, 0))
            out[key] = (ms + us / 1e3 / calls, n + e.count / calls)
    return out if any(ms > 0.0 for ms, _ in out.values()) else {}


def device_launches(fn, names, calls: int = 10):
    """Launches of the port's kernels (``names``) a call of fn, from
    ``device_events`` over ``calls`` calls (a launch the profiler missed
    shows as a fraction); None where the profiler recorded no device
    time."""
    ev = device_events(fn, calls)
    if not ev:
        return None
    n = sum(c for k, (_, c) in ev.items() if k in names)
    return int(n) if n == int(n) else n


def nnz(t) -> int:
    return int((t != 0).sum())


def newton_ops(cons) -> int:
    """Operations of A^T D A added to the Hessian: banded, the nonzeros of
    the Wd and Wo tables; dense, per row with r nonzeros r products and
    r (r + 1) / 2 FMAs (csrc/ipm_group.cuh:form_newton)."""
    if cons.band is None:
        r = (cons.Wd != 0).sum(1).tolist()
        return sum(k + k * (k + 1) for k in r)
    return (2 * nnz(cons.Wd) + cons.n + 2 * nnz(cons.Wo) + cons.n
            - cons.band)


def mehrotra_ops(cons, iters: int, p_nnz: int) -> int:
    """Operations of one lane's Mehrotra loop and slack start, counted
    from csrc/ipm_group.cuh (FMA = 2; divide, sqrt, compare and
    min/max = 1), leaving out the structural zeros of this run's
    lane-shared A, Wd and Wo; ``p_nnz`` entries of the Hessian take part
    in r_d = Pr x."""
    n, mc = cons.n, cons.mc
    nA = nnz(cons.A)
    chol = 2 * n + n * (n + 1) // 2 + (n - 1) * n * (n + 1) // 3
    direction = 4 * nA + 7 * mc + n + 2 * n * n         # A^T t, solve, A dx
    per_iter = (2 * mc + 1                              # mu
                + 2 * nA + 3 * mc                       # r_p, max |r_p|
                + 2 * nA + 2 * p_nnz + 2 * n + 2        # r_d, active
                + 3 * mc                                # D
                + newton_ops(cons)
                + chol + mc                             # factor, r_slam
                + 2 * direction + 4 * 3 * mc + 2        # dirs, step ratios
                + 6 * mc + 4 + 4 * mc + 1               # mu_aff, corrector
                + 3 * n + 6 * mc)                       # update
    return 2 * nA + 2 * mc + iters * per_iter           # slack start + loop


def gram_ops(live, n: int) -> int:
    """The factored Gram's operations from each W row's live entries
    (live[r*n + i]: W[r, i] is not a structural zero): per row with k of
    them, k FMAs into qv and k (k + 1) / 2 into the lower triangle; then
    the factor 2."""
    ops = 0
    for r in range(len(live) // n):
        k = sum(live[r * n:(r + 1) * n])
        ops += 2 * k + k * (k + 1)
    return ops + n + n * (n + 1) // 2


def factored_tail_ops(cons, iters: int) -> int:
    """The factored QP's tail from the Gram: objective scale, scaled and
    regularized Hessian and gradient, the warm dual start, the Mehrotra
    loop (the per-lane Hessian's n*n entries)."""
    n = cons.n
    return (2 * n + 1 + n * (n + 1) // 2 + n + 4 * cons.mc
            + mehrotra_ops(cons, iters, n * n))


def qp_ops(qp, iters: int) -> int:
    """Operations one lane's bilinear QP needs, counted from
    csrc/kmpc_device.cuh (the assembly) and csrc/ipm_group.cuh (the
    interior point), leaving out the structural zeros of this run's
    lane-shared operands: no product with a zero entry of the generators,
    A, Wd, Wo or F0r, and no Gram term of an all-zero W generator row (a
    stage no move reaches).  The lift-fused QP's generator columns act on
    [zeta; monomials; 1], the assembly-fused one's (``bilin``) on z."""
    n, p, m = qp.n, qp.p, qp.m
    lifted = hasattr(qp, "nmono")
    nf = qp.nz + qp.nmono if lifted else qp.nzl
    feat = (qp.gens[:, :nf] != 0).sum(1).tolist()
    const = (qp.gens[:, nf] != 0).tolist() if lifted else [0] * len(feat)
    gen = [2 * f + c for f, c in zip(feat, const)]     # one row against f
    live = [g > 0 for g in gen]
    pn, mp = p * n, m * p
    ops = qp.nmono if lifted else 0                     # monomials
    ops += sum(gen[pn + mp:]) + p                       # v = Pgen f - sqYr
    ops += sum(gen[pn:pn + mp]) + 2 * sum(live[pn:pn + mp])   # + CB0 u
    ops += sum(gen[:pn]) + gram_ops(live[:pn], n)       # W rows -> Gram, qv
    ops += 2 * nnz(qp.F0r)                              # b
    return ops + factored_tail_ops(qp.cons, iters)


def linear_grad_ops(op) -> int:
    """Operations of the linear step's gradient and right-hand side: the
    monomials, the nonzeros of the gradient generators, the reference
    column, the u_prev coupling and b = cFr - F0r u_prev."""
    nf = op.nz + op.nmono
    feat = (op.G1[:, :nf] != 0).sum(1).tolist()
    const = (op.G1[:, nf] != 0).tolist()
    return (op.nmono + sum(2 * f + c for f, c in zip(feat, const))
            + op.cons.n + 2 * nnz(op.P21) + 2 * nnz(op.F0r))


def ok_ops(cons) -> int:
    """Operations of the ok mask (gap, primal residual, finite x)."""
    return 2 * cons.mc + 1 + 2 * nnz(cons.A) + 3 * cons.mc + cons.n


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
    """Operations of one lane's SDIRK2 period and outputs, counted from
    csrc/kmpc_device.cuh: one dual-number Jacobian and its factor a
    period (jac_mode 'step') or a substep ('substep'); the markers' or
    (no operation) the angles'."""
    nl, nx = cfg.Nlinks, cfg.nx
    chol = sum(2 * j + 1 + (nx - 1 - j) * (2 * j + 1) for j in range(nx))
    solve = 2 * nx * (nx - 1) + 2 * nx
    factor = (rhs_ops(nl, nx) + 2 * nx * nx
              + nx * (nx + 1) // 2 * (2 * nx - 1) + chol)
    newton = 2 * nx + rhs_ops(nl, 0) + nx + nx * (2 * nx - 1) + solve + nx
    substep = rhs_ops(nl, 0) + 2 * cfg.newton_iters * newton + 7 * nx
    markers = 0 if cfg.output_type == "angles" else 7 * nl - 3
    factors = cfg.substeps if cfg.jac_mode == "substep" else 1
    return 6 + factors * factor + cfg.substeps * substep + markers


def step_tail_ops(op, cfg, lam_scaled: bool) -> int:
    """The step kernels' epilogue: input unscaling, finite check, output
    scaling, Pwarm @ x by its nonzeros, the dual carry's scaling (the
    bilinear step's lam * obj; the linear step carries lam as it is)."""
    return (2 * op.mpc.m + cfg.nx + 2 * cfg.ny + 2 * nnz(op.Pwarm)
            + (op.cons.mc if lam_scaled else 0))


def nmpc_part_ops(q) -> dict:
    """Operations of the parts of one lane's NMPC pass, counted from
    csrc/nmpc_device.cuh, leaving out the structural zeros of this run's
    lane-shared operands (A1, A2, G, CzS, A, Wd, Wo) and of the
    sensitivities: S starts at 0, and stage k's projection and propagation
    touch only the decision columns that the input blocks of stages
    0..k-1 reach.  ``glow``: g_low's monomials; ``F``: the dynamics (g_low
    and the top-degree terms included); ``J``: G g_low + A1; ``defects``;
    ``sweep``: the condensation streamed into the Gram over all stages;
    ``finish``: the Gram's factor 2, the objective scale and the scaled,
    regularized Hessian (the Levenberg term and the dual start apart)."""
    nz, nza, m, n, Np = q.nz, q.nza, q.m, q.n, q.Np
    ntop = len(q.tables_host[-1][0]) if q.tables_host else 0
    glow = q.nlow - nza
    sweep, live = 0, 0
    for k in range(Np + 1):
        for r in range(q.nproj):
            c = nnz(q.CzS[k * q.nproj + r])
            a = max(live - m, 0)
            sweep += 2 * c * (live + 1) + 1 + (2 * m if live else 0) \
                + 2 * a + a * (a + 1)
        if k < Np:
            sweep += 2 * nz * nz * live + m * nz + 2 * nz * nz + nz
            live = q.cols[k] + m
    return dict(glow=glow,
                F=glow + ntop + 2 * nnz(q.A1) + 2 * nnz(q.A2) + nz,
                J=2 * nnz(q.G) + nza * nz, defects=2 * nz * nza,
                sweep=sweep,
                finish=n * (n + 1) // 2 + n + 1 + n + n * (n + 1) // 2 + n)


def nmpc_ops(q, passes: int, hold0: bool, iters: int) -> int:
    """Operations of one lane's whole-SQP NMPC solve (nmpc_multipass.cu):
    per pass the stage evaluations (one in the 'hold' pass), the sweep,
    the finish with the Levenberg term q0c * x_prev and the Mehrotra loop;
    b = cFr - F0r u_prev and the pass-0 plan Gup u_prev once."""
    p = nmpc_part_ops(q)
    stage = p["F"] + p["J"] + p["defects"]
    total = 2 * nnz(q.F0r) + 2 * nnz(q.Gup)
    for k in range(passes):
        evals = 1 if (k == 0 and hold0) else q.Np
        total += (evals * stage + p["sweep"] + 3 * q.n + p["finish"]
                  + mehrotra_ops(q.cons, iters, q.n * q.n))
    return total


def nmpc_onepass_ops(q, source: str, iters: int, q0: bool,
                     warm: bool) -> int:
    """Operations of one lane's one-pass NMPC solve: nmpc_stage.cu with
    its trajectory ``source`` 'hold' (F, J and defects once), 'roll' (at
    every stage) or 'ship' (g_low, J and defects at every stage, no F), or
    nmpc_pass.cu (``source`` 'jacobians': none of them); then the sweep,
    the finish with the per-lane term 2 q + q0 (``q0``), the warm dual
    start sqrt(clip(lam0 / obj)) (``warm``), the Mehrotra loop and
    b = cFr - F0r u_prev."""
    p = nmpc_part_ops(q)
    stage = {"hold": p["F"] + p["J"] + p["defects"],
             "roll": q.Np * (p["F"] + p["J"] + p["defects"]),
             "ship": q.Np * (p["glow"] + p["J"] + p["defects"]),
             "jacobians": 0}[source]
    return (2 * nnz(q.F0r) + stage + p["sweep"] + (2 if q0 else 1) * q.n
            + p["finish"] + (4 * q.cons.mc if warm else 0)
            + mehrotra_ops(q.cons, iters, q.n * q.n))


def bound(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def carry_bytes(c) -> int:
    """Each carry field read once and written once (the loads are not
    written)."""
    return 2 * nbytes(*c) - nbytes(c.w)


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
    from koopman_realizations_torch.control.kmpc import (
        BilinearKmpc,
        LinearKmpc,
        NonlinearKmpc,
    )
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.ops.kernels import _build
    from koopman_realizations_torch.ops.kernels import batch_chol as BC
    from koopman_realizations_torch.ops.kernels import bilin as BI
    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    from koopman_realizations_torch.ops.kernels import ipm_factored as IF
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.ops.kernels import linear_step_fused as LS
    from koopman_realizations_torch.ops import nmpc as N
    from koopman_realizations_torch.ops.kernels import nmpc_multipass as NM
    from koopman_realizations_torch.ops.kernels import nmpc_pass as NP
    from koopman_realizations_torch.ops.kernels import nmpc_stage as NS
    from koopman_realizations_torch.ops.kernels import step_fused as SF
    from koopman_realizations_torch.ops.qp import ok_mask, solve_qp
    from koopman_realizations_torch.utils.checkpoint import (
        LINEAR_MODEL,
        NONLINEAR_MODEL,
        load_model,
    )
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
    wrappers = {"step_fused": SF.step_fused_cuda,
                "bilin_lift": BL.bilin_lift_cuda,
                "linear_step_fused": LS.linear_step_fused_cuda,
                "ipm_shared": IS.ipm_shared_cuda,
                "nmpc_multipass": NM.nmpc_multipass_cuda,
                "nmpc_stage": NS.nmpc_stage_cuda,
                "nmpc_pass": NP.nmpc_pass_cuda,
                "bilin": BI.bilin_cuda,
                "ipm_factored": IF.ipm_factored_cuda,
                "batch_chol": BC.solve_spd_cuda}

    def drive(expected, fn):
        """Run one main path with every launch count set to 0 just before
        and read just after: (result, seconds by CUDA events, counts).
        Fails unless the kernels launched exactly as ``expected``
        ({name: launches}; any other kernel: none)."""
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        if any(counts[k] != expected.get(k, 0) for k in counts):
            raise AssertionError(f"main path launches {counts}, expected "
                                 f"{expected}")
        return out, t0.elapsed_time(t1) / 1e3, counts

    def nmpc_launches(m, steps):
        """The NMPC kernels' launches of ``steps``-step run: the first SQP
        of every step on the controller's route (one multipass launch, or
        one launch a pass: nmpc_stage, nmpc_pass or, on the 'linear'
        route, ipm_factored), multistart's second SQP a launch a pass."""
        passes = (steps - 1) * m.cfg.sqp_iters
        per_pass = "ipm_factored" if m.linear_update else \
            "nmpc_stage" if m.jac_period == 1 else "nmpc_pass"
        out = {"nmpc_multipass": steps - 1} if m.route == "multipass" \
            else {per_pass: passes}
        if m.cfg.sqp_multistart:
            out[per_pass] = out.get(per_pass, 0) + passes
        return out

    def route_launches(m, steps):
        """The bilinear kernels' launches of a ``steps``-step run off the
        lift-fused route: the blocked first QP on ``bilin``, every other
        QP on ``ipm_factored``."""
        qps = (steps - 1) * m.cfg.bilinear_iters
        if not m.blocked:
            return {"ipm_factored": qps}
        return {"bilin": steps - 1, "ipm_factored": qps - (steps - 1)}

    # ---- models, controllers, plant; build all nine kernels (thirteen
    # builds) at once
    model, scaler, header = load_model()
    jref = header["jax_reference"]
    lmodel, lscaler, lheader = load_model(LINEAR_MODEL)
    ljref = lheader["jax_reference"]
    nmodel, nscaler, nheader = load_model(NONLINEAR_MODEL)
    njref = nheader["jax_reference"]
    dev = torch.device("cuda")
    mpc = BilinearKmpc(model, scaler, MpcConfig(**MPC), device=dev)
    lmpc = LinearKmpc(lmodel, lscaler, MpcConfig(**LINEAR_MPC), device=dev)
    nmpc = NonlinearKmpc(nmodel, nscaler, MpcConfig(**NMPC_MPC), device=dev)
    arm = Arm(ArmConfig(**ARM), device=dev)
    sim = Ksim(arm, mpc)
    lsim = Ksim(arm, lmpc)
    nsim = Ksim(arm, nmpc)
    op = SF.build_step_fused(mpc, arm, scaler)
    lop = LS.build_linear_step_fused(lmpc, arm, lscaler)
    qp, cons, nqp = op.qp, lmpc.constraints(), nmpc.nmpc_qp()
    ref = blockM_reference()
    wins = sim.reference_windows(ref, STEPS)
    fY = lop.fYr(lsim.reference_windows(ref, STEPS))
    nwins = nsim.reference_windows(ref, STEPS)
    route_refs = json.loads(ROUTE_REFS.read_text())["regimes"]
    rmpcs, rsims64 = {}, {}
    for name, entry in route_refs.items():
        rcfg = MpcConfig(**{**MPC, **entry["knobs"]})
        rmpcs[name] = BilinearKmpc(model, scaler, rcfg, device=dev)
        rsims64[name] = BilinearKmpc(model, scaler, rcfg, device=dev,
                                     dtype=torch.float64)
    ipmf_specs = {name: IF.kernel_spec(m.constraints(), m.p)
                  for name, m in rmpcs.items()}
    # the 'linear' update's controller in f32 and f64
    qcfg = MpcConfig(**regime_configs()[LINEAR_REGIME])
    qmpc = NonlinearKmpc(nmodel, nscaler, qcfg, device=dev)
    qmpc64 = NonlinearKmpc(nmodel, nscaler, qcfg, device=dev,
                           dtype=torch.float64)
    qcons, ucons = qmpc.constraints(), rmpcs["unblocked"].constraints()
    specs = ([BL.kernel_spec(qp), op.kernel_spec(), IS.kernel_spec(cons),
              lop.kernel_spec(), NM.kernel_spec(nqp), NP.kernel_spec(nqp)]
             + [NS.kernel_spec(nqp, mode) for mode in N.STAGE_MODES]
             + [BI.kernel_spec(rmpcs["iters2"].bilin_qp())]
             + list(ipmf_specs.values())
             + [IF.kernel_spec(qcons, nqp.p, q0=True),
                IS.kernel_spec(qcons, lane_p=True),
                IS.kernel_spec(ucons, lane_p=True),
                BC.kernel_spec(qcons.n), BC.kernel_spec(ucons.n)])
    # the loaded experiment's four new builds (phase LD)
    Lx = loaded_setup(dev)
    specs += list(Lx.specs.values())
    # every dictionary's paths (phase DX): the new builds of bilin_lift
    # (nz=15, degree 2), bilin (NL=84, NL=19) and nmpc_pass (jacfwd)
    Dx = dict_setup(dev, arm)
    for sp in Dx.specs.values():
        if sp not in specs:
            specs.append(sp)
    # the harness slice's new builds (phase RN): both fused steps with
    # jac_mode 'substep' on markers and on angles, ipm_shared's lane-shared
    # warm-dual build and its n=27 builds
    Rx = rn_setup(dev)
    for sp in Rx.specs.values():
        if sp not in specs:
            specs.append(sp)
    # the unblocked NMPC's and the loaded delayed model's builds (phase
    # NU): nmpc_multipass, nmpc_stage (each mode), nmpc_pass (chord,
    # jacfwd) and ipm_factored's q0 build at n=27, bilin at the delayed NL
    Ux = nu_setup(dev)
    for sp in Ux.specs.values():
        if sp not in specs:
            specs.append(sp)
    builds = _build.build_all(specs)
    ptxas_of = {sp: r.ptxas for sp, r in zip(specs, builds)}
    names = kernel_names(_build.CSRC)
    dev_launches = {}

    def ptx(spec) -> str:
        """A build's ``ptxas -v`` lines, joined."""
        return " | ".join(ln.split("ptxas info    :")[-1].strip()
                          for ln in ptxas_of[spec]
                          if "Compile time" not in ln)

    def kernel_ms(name, fn, reps: int, warmup: int = 2,
                  build: str = "") -> float:
        """``cuda_ms`` of a call of kernel ``name``'s wrapper and, at the
        first timing of each of its builds (``build``), the launches of the
        port's kernels in one call (``device_launches``); a call that
        launches none fails."""
        ms = cuda_ms(fn, reps, warmup)
        per = dev_launches.setdefault(name, {})
        if build not in per:
            per[build] = device_launches(fn, names)
            if per[build] == 0:
                raise AssertionError(f"{name} {build}: its wrapper launched "
                                     f"no kernel of the port")
        return ms

    def launches_per_call(name):
        """The launches a call of ``name``'s wrapper: one number where its
        builds agree, else each build's."""
        per = dev_launches[name]
        vals = set(per.values())
        return vals.pop() if len(vals) == 1 else per

    def plan_line(kernel, mode=None) -> str:
        """A build's plan and its ``ptxas -v`` lines (the one-pass NMPC
        kernels, the fused steps, ``bilin_lift``, ``bilin``,
        ``ipm_shared``'s lane-shared build and, 'ipm_shared lane-P', its
        per-lane-P build of the constraints ``mode``; ``batch_chol``'s
        build of n = ``mode``)."""
        ptx = lambda spec: " | ".join(
            ln.split("ptxas info    :")[-1].strip()
            for ln in ptxas_of[spec] if "Compile time" not in ln)
        if kernel == "batch_chol":
            return (f"plan: {BC.launch_plan(mode).describe()}; ptxas: "
                    + ptx(BC.kernel_spec(mode)))
        if kernel == "bilin":
            bq = rmpcs["iters2"].bilin_qp()
            plan, spec = BI.launch_plan(bq), BI.kernel_spec(bq)
        elif kernel == "nmpc_stage":
            plan, spec = NS.launch_plan(nqp), NS.kernel_spec(nqp, mode)
        elif kernel == "nmpc_pass":
            plan, spec = NP.launch_plan(nqp), NP.kernel_spec(nqp)
        elif kernel == "bilin_lift":
            plan, spec = BL.launch_plan(qp), BL.kernel_spec(qp)
        elif kernel.startswith("ipm_shared"):
            lane_p = kernel.endswith("lane-P")
            c_ = mode if lane_p else cons
            plan, spec = IS.launch_plan(c_, lane_p), IS.kernel_spec(c_, lane_p)
        else:
            so = op if kernel == "step_fused" else lop
            plan, spec = so.launch_plan(), so.kernel_spec()
        return (f"plan: group {plan.group}, {plan.threads} threads and "
                f"{plan.lanes} lanes a block, "
                f"{plan.min_blocks or 'no bound on'} blocks an SM; ptxas: "
                + ptx(spec))
    for r in builds:
        log(f"built {r.path.name} in {r.seconds:.1f} s "
            f"({'cached' if r.cached else 'nvcc'})")
        for ln in r.ptxas:
            log("  " + ln.strip())

    # ---- phase G: the plant's CUDA graph (``models/arm.py:PlantGraph``,
    # which every general runner, the lasso sweep and the loaded loops
    # replay) against the eager step, bitwise, over two periods: the
    # bench's 3-link arm (jac_mode 'step') at B=65536 and the loaded 2-link
    # arm ('substep': 5 substeps, 3 Newton iterations) at B=2048
    def check_graph(a, B, label):
        X, U, Wl = plant_lanes(a, B)
        a.clear_graphs()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved(dev)
        xg = a.step(X, U, Wl)
        pool = (torch.cuda.memory_reserved(dev) - r0) / 2 ** 20
        xg2 = a.step(xg, U, Wl)
        xe = a.step_eager(X, U, Wl)
        xe2 = a.step_eager(xe, U, Wl)
        bits = lambda t: t.view(torch.int32)
        same = torch.equal(bits(xe), bits(xg)) \
            and torch.equal(bits(xe2), bits(xg2))
        t_e = cuda_ms(lambda: a.step_eager(X, U, Wl), reps=3, warmup=1)
        t_g = cuda_ms(lambda: a.step(X, U, Wl), reps=10)
        log(f"G plant graph {label} B={B}: bitwise the eager step over two "
            f"periods {same}; a period {t_g:.3f} ms replayed, "
            f"{t_e:.3f} ms eager (CUDA events); the capture reserved "
            f"{pool:.1f} MiB (its memory pool) | {smi}")
        if not (same and bool(torch.isfinite(xg2).all())):
            raise AssertionError(f"G {label}: the graphed plant is not the "
                                 f"eager one")

    check_graph(arm, B_GENERAL, "3-link, jac_mode 'step'")
    check_graph(Lx.arm, Lx.r["B_full"], "loaded 2-link, jac_mode 'substep'")

    def spread_X0(B):
        X0 = np.zeros((B, 6), np.float32)
        X0[:, 0] = np.linspace(-0.2, 0.2, B)
        return X0

    def carry_after(step_op, vecs, B, steps):
        """Carry after ``steps`` plain closed-loop steps from the bench's
        initial states spread over B lanes."""
        c = step_op.init_carry(spread_X0(B), np.zeros((B, 2), np.float32))
        for k in range(steps):
            c = step_op.step_plain(c, vecs[k])
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
        okk = ok_mask(qp.cons, b, xk, sk, lk, 3e-3, 5e-2)[0]
        okp = ok_mask(qp.cons, b, xp, sp, lp, 3e-3, 5e-2)[0]
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

    def check_step(step_op, c, v, label) -> float:
        """A fused step kernel against its plain version on one carry;
        returns the max |d| over the outputs."""
        out = SF.StepCarry(*(torch.empty_like(t) for t in c))
        ck = step_op.step(c, v, out=out)
        torch.cuda.synchronize()
        cp = step_op.step_plain(c, v)
        d = {f: (getattr(ck, f) - getattr(cp, f)).abs().max().item()
             for f in SF.StepCarry._fields}
        log(f"{label}: " + " ".join(
            f"max|d{f}| {v:.3e}" for f, v in d.items()))
        # QP outputs: f32 orderings (<1e-3 of scale); plant outputs: the
        # f32 chord-Newton SDIRK2 is noisy at ~3e-3 in any two orderings
        if not (torch.equal(ck.alive, cp.alive) and d["upsc"] < 1e-3
                and d["x0"] < 1e-3
                and d["lamc"] < 1e-3 * max(1.0, cp.lamc.abs().max().item())
                and d["xpl"] < 2e-2):
            raise AssertionError(f"{label}: kernel disagrees with plain")
        return max(d.values())

    def check_runners(name, step_op, op64, vecs, vecs64, K=20) -> float:
        """K-step runners from the same lanes: kernel vs plain f32 vs plain
        f64; returns the max |dYp| of kernel and plain f32."""
        ck = carry_after(step_op, vecs, B_CHECK, 0)
        cp = carry_after(step_op, vecs, B_CHECK, 0)
        c64 = carry_after(op64, vecs64, B_CHECK, 0)
        dY = []
        for k in range(K):
            ck = step_op.step(ck, vecs[k])
            cp = step_op.step_plain(cp, vecs[k])
            c64 = op64.step_plain(c64, vecs64[k])
            if not torch.equal(ck.alive, cp.alive):
                raise AssertionError(f"{name}: alive masks differ at step "
                                     f"{k}")
            dY.append((ck.yp - cp.yp).abs().max().item())
        ek = (ck.yp.double() - c64.yp).abs().max(0).values
        ep = (cp.yp.double() - c64.yp).abs().max(0).values
        med = (ck.yp - cp.yp).abs().max(0).values.median().item()
        log(f"{name} {K}-step runners: max|dYp| first 5 {max(dY[:5]):.3e},"
            f" all {K} {max(dY):.3e}, median lane at {K} {med:.3e}; error "
            f"vs f64: kernel max {ek.max():.3e} median {ek.median():.3e}, "
            f"plain max {ep.max():.3e} median {ep.median():.3e}; alive "
            f"{ck.alive.mean().item():.4f}")
        # single lanes of the early blockM transient amplify f32 plant
        # noise; the kernel must be as accurate as the plain f32 runner
        # against f64
        if not (max(dY[:5]) < 2e-2 and max(dY) < 0.2 and med < 2e-3
                and ek.median() <= 2 * ep.median() + 1e-4
                and ek.max() <= 2 * ep.max() + 1e-2
                and bool(ck.alive.all())):
            raise AssertionError(f"{name} runner disagrees with plain")
        return max(dY)

    c = carry_after(op, wins, B_CHECK, 3)
    bl_err = max(check_bilin(c, True, wins[3], f"warm B={B_CHECK}"),
                 check_bilin(c, False, wins[3], f"cold B={B_CHECK}"),
                 check_bilin(c, True, lane_windows(B_CHECK, 3),
                             f"warm, per-lane windows B={B_CHECK}"))

    # ---- phase 2: step_fused kernel against its plain version, B=8192
    c = carry_after(op, wins, B_CHECK, 5)
    sf_err = max(check_step(op, c, wins[5], f"step_fused one step "
                            f"B={B_CHECK}"),
                 check_step(op, c, lane_windows(B_CHECK, 5),
                            f"step_fused one step, per-lane windows "
                            f"B={B_CHECK}"))
    mpc64 = BilinearKmpc(model, scaler, MpcConfig(**MPC), device=dev,
                         dtype=torch.float64)
    op64 = SF.build_step_fused(mpc64, arm, scaler)
    wins64 = Ksim(arm, mpc64).reference_windows(ref, STEPS)
    check_runners("step_fused", op, op64, wins, wins64)
    del op64, mpc64, wins64

    # ---- phase L1: ipm_shared kernel against its plain version, B=8192,
    # on the linear general path's QPs from a carry after 3 plain steps
    def linear_qp(c, k):
        """LinearKmpc.solve's equilibrated QP at carry c, reference step k:
        (Psh, q, b) as ``LinearKmpc.qp_args`` hands them to the kernel."""
        Yr = lsim.reference_windows(ref, k + 2)[k]
        # (the primal start is the carry's own x0)
        return lmpc.qp_args(lmpc.lift(c.ysc), c.upsc, Yr,
                            c.upsc.repeat(lmpc.Np, 1))[0][1:4]

    def check_ipm(c, k, label) -> float:
        Psh, q, b = linear_qp(c, k)
        args = (cons, Psh, q, b, c.x0, lmpc.cfg.qp_iters, 1e-2)
        xk, sk, lk = IS.ipm_shared_cuda(*args)
        torch.cuda.synchronize()
        xp, sp, lp = IS.ipm_shared_plain(*args)
        okk = ok_mask(cons, b, xk, sk, lk, 3e-3, 5e-2)[0]
        okp = ok_mask(cons, b, xp, sp, lp, 3e-3, 5e-2)[0]
        dx = (xk - xp).abs().max().item()
        dl = (lk - lp).abs().max().item() / lp.abs().max().item()
        log(f"ipm_shared {label}: max|dx| {dx:.3e} max|dlam|/max|lam| "
            f"{dl:.3e} ok {int(okk.sum())}/{int(okp.sum())} of "
            f"{q.shape[1]}")
        # two f32 orderings of six unconverged iterations; each is ~1e-4
        # from the f64 solution in the CPU tests
        if not (dx < 1e-3 and dl < 1e-3 and torch.equal(okk, okp)
                and bool(okk.all())):
            raise AssertionError("ipm_shared kernel disagrees with plain")
        return dx

    lc = carry_after(lop, fY, B_CHECK, 3)
    is_err = check_ipm(lc, 3, f"B={B_CHECK}")

    # ---- phase L2: linear_step_fused kernel against its plain version
    lc = carry_after(lop, fY, B_CHECK, 5)
    ls_err = check_step(lop, lc, fY[5], f"linear_step_fused one step "
                        f"B={B_CHECK}")
    lmpc64 = LinearKmpc(lmodel, lscaler, MpcConfig(**LINEAR_MPC),
                        device=dev, dtype=torch.float64)
    lop64 = LS.build_linear_step_fused(lmpc64, arm, lscaler)
    fY64 = lop64.fYr(Ksim(arm, lmpc64).reference_windows(ref, STEPS))
    check_runners("linear_step_fused", lop, lop64, fY, fY64)
    del lop64, lmpc64, fY64

    # ---- phase N1: nmpc_multipass kernel against its plain version,
    # B=8192, on lanes after 3 closed-loop steps, each lane with the
    # reference window of another step
    sqp = (nmpc.cfg.sqp_iters, nmpc.hold0, nmpc.cfg.qp_iters)
    nmpc64 = NonlinearKmpc(nmodel, nscaler, MpcConfig(**NMPC_MPC),
                           device=dev, dtype=torch.float64)
    nqp64 = nmpc64.nmpc_qp()

    def nmpc_lanes(B, steps, ctl=nmpc):
        """Scaled outputs and previous inputs after ``steps`` closed-loop
        steps of the NMPC general path (controller ``ctl``) from the spread
        initial states."""
        m = ctl.m
        x = torch.as_tensor(spread_X0(B), device=dev).T.contiguous()
        W = x.new_zeros((2, B))
        u_prev = x.new_zeros((m, B))
        ysc = nscaler.y_down(arm.get_y(x), axis=0)
        upsc = nscaler.u_down(u_prev, axis=0)
        for k in range(steps):
            U, _ = ctl.solve(ysc, upsc, nwins[k])
            x = arm.step(x, u_prev, W)
            ysc = nscaler.y_down(arm.get_y(x), axis=0)
            upsc = U[m:2 * m].contiguous()
            u_prev = nscaler.u_up(upsc, axis=0)
        return ysc.contiguous(), upsc

    def check_nmpc(zeta, up, sq, label) -> float:
        """nmpc_multipass kernel against its plain version, both against
        the plain f64 version; returns max |dx| of kernel and plain."""
        args = (nqp, zeta, up, sq, *sqp)
        xk, sk, lk, objk = NM.nmpc_multipass_cuda(*args)
        torch.cuda.synchronize()
        xp, sp, lp, objp = NM.nmpc_multipass_plain(*args)
        x64 = NM.nmpc_multipass_plain(nqp64, zeta.double(), up.double(),
                                      sq.double(), *sqp)[0]
        b = nqp.cFr[:, None] - nqp.F0r @ up
        okk = ok_mask(nqp.cons, b, xk, sk, lk, 3e-3, 5e-2)[0]
        okp = ok_mask(nqp.cons, b, xp, sp, lp, 3e-3, 5e-2)[0]
        # per-lane distance to the f64 solution: its median and 99th
        # percentile over the lanes (a single lane's extreme is the
        # conditioning of that lane's nonconvex SQP, in both orderings)
        lv = torch.tensor([0.5, 0.99], dtype=torch.float64, device=dev)
        ek = torch.quantile((xk.double() - x64).abs().amax(0), lv)
        ep = torch.quantile((xp.double() - x64).abs().amax(0), lv)
        dx = (xk - xp).abs().max().item()
        dobj = ((objk - objp) / objp).abs().max().item()
        log(f"nmpc_multipass {label}: max|dx| {dx:.3e} max rel dobj "
            f"{dobj:.3e}; distance to f64 (median, p99): kernel "
            f"{ek[0]:.3e} {ek[1]:.3e}, plain f32 {ep[0]:.3e} {ep[1]:.3e};"
            f" ok {int(okk.sum())}/{int(okp.sum())} of {zeta.shape[1]}")
        if not (torch.equal(okk, okp) and bool(okk.all())
                and bool((ek <= 2 * ep + 1e-5).all())):
            raise AssertionError("nmpc_multipass kernel disagrees with plain")
        return dx

    nz8, nu8 = nmpc_lanes(B_CHECK, 3)
    nm_err = max(check_nmpc(nz8, nu8, nwins[3], f"B={B_CHECK}"),
                 check_nmpc(nz8, nu8, nwins[3 + torch.arange(
                     B_CHECK, device=dev) % 8].T.contiguous(),
                     f"per-lane windows B={B_CHECK}"))

    # ---- phase S1: nmpc_stage (each trajectory mode, cold and with warm
    # duals, a per-lane Levenberg term; per-lane windows in one case) and
    # nmpc_pass (fresh and frozen stage Jacobians) against their plain
    # versions, B=8192, on the same lanes: the pass linearizes along the
    # multipass solve's plan, rho = 0.1
    def pass_inputs(zeta, up, sq, rho=0.1):
        """One SQP pass's operands in f32 and f64: the multipass plan as
        the linearization plan Ul, its rollout (Zl, Fv), the stage
        Jacobians at the held state (the frozen ones of a chord pass),
        x0 = Sel Ul, q0 = -2 rho Tb^T Ul and the plan's multipliers in
        row units as the warm dual start."""
        U, sol = nmpc.solve(zeta, up, sq)
        out = {}
        for c in (nmpc, nmpc64):
            q_ = c.nmpc_qp(c.RdT_t + rho * c.bsizes_t)
            Ud, z, u, r = (t.to(c.dtype).contiguous()
                           for t in (U, zeta, up, sq))
            Z = N.rollout(q_, z, Ud)
            out[c.dtype] = dict(
                qp=q_, zeta=z, up=u, sq=r, Ul=Ud, Zl=Z[:-1].contiguous(),
                Fv=Z[1:].contiguous(),
                Jh=N.stage_lin(q_, z.expand((c.Np,) + z.shape),
                               u.repeat(c.Np, 1))[0],
                x0=(c.Sel_t @ Ud[3:]).contiguous(),
                q0=(-2.0 * rho * (c.Tb_t.T @ Ud[3:])).contiguous(),
                lam0=(sol.lam.to(c.dtype) * q_.row[:, None]).contiguous())
        return out

    def onepass(kernel, source, d, warm):
        """(kernel, plain) calls of one nmpc_stage launch with trajectory
        ``source`` or one nmpc_pass launch with 'fresh' or 'frozen'
        Jacobians, on the operands d."""
        if kernel == "nmpc_stage":
            head = (d["qp"], source)
            kw = {"ship": dict(Zl=d["Zl"], Ul=d["Ul"], Fv=d["Fv"]),
                  "roll": dict(Ul=d["Ul"]), "hold": {}}[source]
            fns = NS.nmpc_stage_cuda, NS.nmpc_stage_plain
        else:
            head = (d["qp"],) + N.stage_lin(
                d["qp"], d["Zl"], d["Ul"],
                frozen=d["Jh"] if source == "frozen" else None, Fv=d["Fv"])
            kw = {}
            fns = NP.nmpc_pass_cuda, NP.nmpc_pass_plain
        args = head + (d["zeta"], d["up"], d["sq"], d["x0"], d["q0"],
                       d["lam0"] if warm else None, nmpc.cfg.qp_iters, 1e-2)
        return tuple((lambda f=f: f(*args, **kw)) for f in fns)

    def check_onepass(kernel, source, ins, warm, label) -> float:
        """A one-pass kernel against its plain version, both against the
        plain f64 version (as check_nmpc); returns max |dx| of kernel
        and plain."""
        kcall, pcall = onepass(kernel, source, ins[torch.float32], warm)
        xk, sk, lk, objk = kcall()
        torch.cuda.synchronize()
        xp, sp, lp, objp = pcall()
        x64 = onepass(kernel, source, ins[torch.float64], warm)[1]()[0]
        d = ins[torch.float32]
        b = N.rhs(d["qp"], d["up"])
        okk = ok_mask(d["qp"].cons, b, xk, sk, lk, 3e-3, 5e-2)[0]
        okp = ok_mask(d["qp"].cons, b, xp, sp, lp, 3e-3, 5e-2)[0]
        lv = torch.tensor([0.5, 0.99], dtype=torch.float64, device=dev)
        ek = torch.quantile((xk.double() - x64).abs().amax(0), lv)
        ep = torch.quantile((xp.double() - x64).abs().amax(0), lv)
        dx = (xk - xp).abs().max().item()
        dobj = ((objk - objp) / objp).abs().max().item()
        log(f"{kernel} {source} {'warm' if warm else 'cold'} duals {label}: "
            f"max|dx| {dx:.3e} max rel dobj {dobj:.3e}; distance to f64 "
            f"(median, p99): kernel {ek[0]:.3e} {ek[1]:.3e}, plain f32 "
            f"{ep[0]:.3e} {ep[1]:.3e}; ok {int(okk.sum())}/{int(okp.sum())}"
            f" of {xk.shape[1]}")
        if not (torch.equal(okk, okp)
                and bool((ek <= 2 * ep + 1e-5).all())):
            raise AssertionError(f"{kernel} kernel disagrees with plain")
        return dx

    for mode in N.STAGE_MODES:
        log(f"nmpc_stage {mode} {plan_line('nmpc_stage', mode)}")
    log(f"nmpc_pass {plan_line('nmpc_pass')}")
    sin = pass_inputs(nz8, nu8, nwins[3])
    ns_err = max(check_onepass("nmpc_stage", mode, sin, warm, f"B={B_CHECK}")
                 for mode in N.STAGE_MODES for warm in (False, True))
    ns_err = max(ns_err, check_onepass(
        "nmpc_stage", "roll", pass_inputs(nz8, nu8, nwins[3 + torch.arange(
            B_CHECK, device=dev) % 8].T.contiguous()), True,
        f"per-lane windows B={B_CHECK}"))
    np_err = max(check_onepass("nmpc_pass", jac, sin, True, f"B={B_CHECK}")
                 for jac in ("fresh", "frozen"))
    del nz8, nu8, sin

    # ---- phase R1: bilin and the three ipm_factored builds against their
    # plain versions, B=8192, on closed-loop lanes of each configuration
    # off the lift-fused route (after 3 steps of its general path: the
    # states, inputs, plans and multipliers its kernels are given),
    # cold and with the carried duals; iters2's ipm_factored pass on the
    # W and v re-rolled from the carried plan
    def route_lanes(name, B, steps=3):
        """Lifted states, previous inputs, plans and multipliers (original
        units) after ``steps`` closed-loop steps of a route's general path
        from the spread initial states."""
        m = rmpcs[name]
        x = torch.as_tensor(spread_X0(B), device=dev).T.contiguous()
        W = x.new_zeros((2, B))
        u_prev = x.new_zeros((m.m, B))
        ysc = scaler.y_down(arm.get_y(x), axis=0)
        upsc = scaler.u_down(u_prev, axis=0)
        U, lam = upsc.repeat(m.Np, 1), x.new_ones((m.n_con, B))
        for k in range(steps):
            U, sol = m.solve(m.lift(ysc), upsc, wins[k], U, lam)
            lam = sol.lam
            x = arm.step(x, u_prev, W)
            ysc = scaler.y_down(arm.get_y(x), axis=0)
            upsc = U[m.m:2 * m.m].contiguous()
            u_prev = scaler.u_up(upsc, axis=0)
        return m.lift(ysc).contiguous(), upsc, U, lam

    def route_inputs(name, lanes, sq, warm):
        """(bilin, ipm_factored) argument tuples of a route's kernels in
        f32 and f64 on the lanes: the plan's shifted start, the carried
        multipliers in row units (or None), for ipm_factored the W, v and
        b the controller assembles (iters2: its re-rolled second pass)."""
        z, up, U, lam = lanes
        out = {}
        for dt, m in ((torch.float32, rmpcs[name]),
                      (torch.float64, rsims64[name])):
            zd, ud, Ud, sd = (t.to(dt) for t in (z, up, U, sq))
            x0 = m.warm_start(Ud).contiguous()
            l0 = (lam.to(dt) * m.row[:, None]).contiguous() if warm else None
            betas = m.roll(zd, Ud)[1] if m.blocked else None
            Wt, v = m.factored_data(zd, ud, sd, betas)
            b = ((m.cF_t[:, None] - m.F0_t @ ud) / m.row[:, None])
            out[dt] = (
                (m.bilin_qp(), zd, ud, x0, l0, sd.contiguous(),
                 m.cfg.qp_iters, 1e-2) if m.blocked else None,
                (m.constraints(), m.rdiag, Wt.contiguous(), v.contiguous(),
                 b.contiguous(), x0, l0, m.cfg.qp_iters, 1e-2))
        return out

    def factored_obj(a64, x):
        """1/2 x'Px + q'x of ipm_factored's QP with P = 2 (W'W + diag r)
        and q = 2 W'v (+ q0), per lane, in original units, f64, for the
        f64 arguments ``a64``."""
        rd, W, v = a64[1], a64[2], a64[3]
        x = x.double()
        Wx = torch.einsum("rib,ib->rb", W, x)
        f = (Wx * Wx + 2.0 * v * Wx).sum(0) + (rd[:, None] * x * x).sum(0)
        q0 = a64[9] if len(a64) > 9 else None
        return f if q0 is None else f + (q0 * x).sum(0)

    def check_qp(kernel, fns, a32, a64, cons, b, label, worst=False):
        """A QP kernel against its plain version (``fns``: the kernel's
        and the plain function), both against the plain f64 version (as
        check_nmpc): equal, all-true ok masks; median and p99 distances to
        f64 within twice plain f32's.  With ``worst`` (ipm_factored's
        arguments) it logs the tail of each ordering -- its lanes farther
        than 1e-3 and 1e-2 from f64 -- and the lane where kernel and plain
        f32 differ most: each one's distance to f64 there, the QP
        objective of the three solutions in original units, the lane's
        smallest slack and gap, and the same lane solved alone with twice
        the iterations.  Returns (max |dx| of kernel and plain, the
        kernel's x)."""
        rk = fns[0](*a32)
        torch.cuda.synchronize()
        rp = fns[1](*a32)
        r64 = fns[1](*a64)
        (xk, sk, lk), (xp, sp, lp), x64 = rk[:3], rp[:3], r64[0]
        okk = ok_mask(cons, b, xk, sk, lk, 3e-3, 5e-2)[0]
        okp = ok_mask(cons, b, xp, sp, lp, 3e-3, 5e-2)[0]
        lv = torch.tensor([0.5, 0.99], dtype=torch.float64, device=dev)
        dk = (xk.double() - x64).abs().amax(0)
        dp = (xp.double() - x64).abs().amax(0)
        ek, ep = torch.quantile(dk, lv), torch.quantile(dp, lv)
        dx = (xk - xp).abs().max().item()
        dobj = "" if len(rk) < 4 else \
            f" max rel dobj {((rk[3] - rp[3]) / rp[3]).abs().max():.3e};"
        log(f"{kernel} {label}: max|dx| {dx:.3e}{dobj} distance to f64 "
            f"(median, p99): kernel {ek[0]:.3e} {ek[1]:.3e}, plain f32 "
            f"{ep[0]:.3e} {ep[1]:.3e}; ok {int(okk.sum())}/{int(okp.sum())}"
            f" of {xk.shape[1]}")
        if worst:
            i = int((xk - xp).abs().amax(0).argmax())
            tail = lambda d: "/".join(str(int((d > t).sum()))
                                      for t in (1e-3, 1e-2))
            lane = lambda a, it: tuple(
                t[..., i:i + 1].contiguous()
                if torch.is_tensor(t) and t.ndim > 1 else t
                for t in a[:7]) + (it,) + tuple(
                t if not torch.is_tensor(t) else t[..., i:i + 1].contiguous()
                for t in a[8:])
            it2 = 2 * a32[7]
            rows = [("kernel", rk, fns[0](*lane(a32, it2))),
                    ("plain f32", rp, fns[1](*lane(a32, it2))),
                    ("f64", r64, fns[1](*lane(a64, it2)))]
            x64_2, a64_i = rows[2][2][0], lane(a64, it2)
            far = lambda x, ref: (x.double() - ref).abs().max().item()
            fobj = lambda x: factored_obj(a64_i, x)[0].item()
            log(f"{kernel} {label}: lanes farther than 1e-3/1e-2 from f64: "
                f"kernel {tail(dk)}, plain f32 {tail(dp)}; worst lane {i}: "
                + "; ".join(
                    f"{nm} |x-x64| {far(r[0][:, i], x64[:, i]):.3e} "
                    f"objective {fobj(r[0][:, i:i + 1]):.10e} min slack "
                    f"{r[1][:, i].min().item():.3e} gap "
                    f"{(r[1][:, i] * r[2][:, i]).mean().item():.3e}, with "
                    f"{it2} iterations |x-x64| {far(r2[0], x64_2):.3e} "
                    f"objective {fobj(r2[0]):.10e}"
                    for nm, r, r2 in rows))
        if not (torch.equal(okk, okp) and bool(okk.all())
                and bool((ek <= 2 * ep + 1e-5).all())):
            raise AssertionError(f"{kernel} kernel disagrees with plain "
                                 f"({label})")
        return dx, xk

    def check_route(kernel, name, ins, label) -> float:
        """One route kernel against its plain version, both against the
        plain f64 version (``check_qp``); returns max |dx| of kernel and
        plain."""
        i = 0 if kernel == "bilin" else 1
        mod = BI if kernel == "bilin" else IF
        a32, a64 = ins[torch.float32][i], ins[torch.float64][i]
        m = rmpcs[name]
        b = m.cFr[:, None] - m.F0r @ a32[2] if kernel == "bilin" else a32[4]
        return check_qp(
            kernel, (getattr(mod, kernel + "_cuda"),
                     getattr(mod, kernel + "_plain")), a32, a64,
            m.constraints(), b, f"({name}, n={m.A.shape[1]}, "
            f"mc={m.A.shape[0]}, band {m.band}) {label}",
            kernel == "ipm_factored")[0]

    bi_err = if_err = 0.0
    for name in rmpcs:
        lanes = route_lanes(name, B_CHECK)
        per_lane = wins[3 + torch.arange(B_CHECK, device=dev) % 8].T
        for warm in (False, True):
            ins = route_inputs(name, lanes, wins[3], warm)
            lab = f"{'warm' if warm else 'cold'} B={B_CHECK}"
            if_err = max(if_err, check_route("ipm_factored", name, ins, lab))
            if rmpcs[name].blocked:
                bi_err = max(bi_err, check_route("bilin", name, ins, lab))
        if rmpcs[name].blocked:
            bi_err = max(bi_err, check_route(
                "bilin", name, route_inputs(name, lanes, per_lane, True),
                f"warm, per-lane windows B={B_CHECK}"))
        del lanes

    # ---- phases Q1, Q2: ipm_factored's q0 build and ipm_shared's
    # per-lane-P build against their plain versions, B=8192, on the
    # 'linear' update's own QPs after 3 closed-loop steps of its general
    # path (the per-lane P as the dense P = 2 (W'W + diag r),
    # q = 2 W'v + q0 of the same lanes), cold and with the first pass's
    # multipliers; the per-lane P also on the unblocked route's lanes
    # (n=27, banded)
    def linear_qps(zeta, up, sq):
        """ipm_factored's arguments for the 'linear' update's second SQP
        pass at these lanes -- the first pass from the held plan, the
        second along its plan's linearized state sequence -- formed by the
        f32 controller as its route does, and the same data in f64:
        (cons, rdiag, W, v, b / row, x0, lam0 * row, iters, slack floor,
        q0), lam0 the first pass's multipliers."""
        m = qmpc
        rho = m.cfg.sqp_damping
        q_ = m.nmpc_qp(m.RdT_t + rho * m.bsizes_t)
        b = m.cF_t[:, None] - m.F0_t @ up
        Ul, Zl = up.repeat(m.Np, 1), zeta.expand((m.Np,) + zeta.shape)
        for it in range(2):
            Jt, cv = N.stage_lin(q_, Zl, Ul)
            W, v = N.condense(q_, Jt, cv, zeta, up, sq)
            x0 = m.Sel_t @ Ul[m.m:]
            q0 = -2.0 * rho * (m.Tb_t.T @ Ul[m.m:])
            if it == 0:
                sol = IF.solve_qp_factored(W, v, q_.rdiag, qcons, b, x0=x0,
                                           iters=m.cfg.qp_iters, q0=q0)
                Ul = m.plan(up, sol.x)
                Zl = N.linear_rollout(q_, Jt, cv, zeta, Ul, m.Sel_t)
        data = (W, v, b / qcons.row[:, None], x0,
                sol.lam * qcons.row[:, None], q0)
        out = {}
        for mm in (qmpc, qmpc64):
            W_, v_, b_, x0_, l_, q0_ = (t.to(mm.dtype).contiguous()
                                        for t in data)
            out[mm.dtype] = (mm.constraints(),
                             (mm.RdT_t + rho * mm.bsizes_t).contiguous(),
                             W_, v_, b_, x0_, l_, mm.cfg.qp_iters, 1e-2, q0_)
        return out

    def dense_qp(a):
        """P = 2 (W'W + diag r) (n, n, B) and q = 2 W'v (+ q0) (n, B) of
        the QP of ipm_factored's arguments ``a``."""
        rd, W, v = a[1:4]
        P = 2.0 * (torch.einsum("rib,rjb->ijb", W, W)
                   + torch.diag(rd)[..., None])
        q = 2.0 * torch.einsum("rib,rb->ib", W, v)
        return P.contiguous(), q if len(a) < 10 else q + a[9]

    def lane_p_args(a, Pq=None):
        """ipm_shared's per-lane-P arguments for the QP of ipm_factored's
        arguments ``a`` (its dense P and q, or ``Pq``): q scaled by the
        lane's iobj = 1 / max |P|, the dual start (row units) by iobj, as
        solve_qp_shared forms them."""
        c, _, _, _, b, x0, l0, iters, sf = a[:9]
        P, q = dense_qp(a) if Pq is None else Pq
        iobj = 1.0 / P.abs().amax((0, 1))
        return (c, P, (q * iobj).contiguous(), b, x0, iters, sf,
                iobj.contiguous(),
                None if l0 is None else (l0 * iobj).contiguous())

    def cold(a, at):
        """The argument tuple ``a`` with its dual start (at ``at``) cold."""
        return a[:at] + (None,) + a[at + 1:]

    def check_linear(ins, label) -> tuple:
        """Q1 (the q0 build) and Q2 (the per-lane-P build on the same
        QPs) on one set of the 'linear' update's QPs: each against its
        plain version and f64, and the two modes' f64 solutions against
        each other (one QP, two Gram orders).  Returns the max |dx| of
        each kernel and its plain version."""
        a32, a64 = ins[torch.float32], ins[torch.float64]
        dq, xq = check_qp("ipm_factored (q0 build)",
                          (IF.ipm_factored_cuda, IF.ipm_factored_plain),
                          a32, a64, qcons, a32[4], label, True)
        l32, l64 = lane_p_args(a32), lane_p_args(a64)
        dl, xl = check_qp("ipm_shared (per-lane P)",
                          (IS.ipm_shared_cuda, IS.ipm_shared_plain), l32,
                          l64, qcons, a32[4], label)
        d64 = (IF.ipm_factored_plain(*a64)[0]
               - IS.ipm_shared_plain(*l64)[0]).abs().max().item()
        lv = torch.tensor([0.5, 0.99], device=dev)
        dql = torch.quantile((xq - xl).abs().amax(0), lv)
        log(f"q0 build vs per-lane P {label}: f64 solutions max|dx| "
            f"{d64:.3e}; kernels (median, p99) {dql[0]:.3e} {dql[1]:.3e}")
        if not d64 < 1e-8:
            raise AssertionError("the q0 and per-lane-P modes solve "
                                 "different QPs")
        return dq, dl

    nzL, nuL = nmpc_lanes(B_CHECK, 3, qmpc)
    lin8 = linear_qps(nzL, nuL, nwins[3 + torch.arange(
        B_CHECK, device=dev) % 8].T.contiguous())
    is_lane_err = 0.0
    for warm in (False, True):
        ins = lin8 if warm else {dt: cold(a, 6) for dt, a in lin8.items()}
        dq, dl = check_linear(ins, f"{'warm' if warm else 'cold'} "
                                   f"B={B_CHECK}")
        if_err, is_lane_err = max(if_err, dq), max(is_lane_err, dl)
    uins = route_inputs("unblocked", route_lanes("unblocked", B_CHECK),
                        wins[3], True)
    is_lane_err = max(is_lane_err, check_qp(
        "ipm_shared (per-lane P)",
        (IS.ipm_shared_cuda, IS.ipm_shared_plain),
        lane_p_args(uins[torch.float32][1]),
        lane_p_args(uins[torch.float64][1]), ucons,
        uins[torch.float32][1][4],
        f"(unblocked, n=27, mc=108, band 3) warm B={B_CHECK}")[0])
    del nzL, nuL, lin8, uins

    # ---- phases 3, L3, N3: quality through the kernels, bench X0, B=16,
    # 301 steps; f32 plant noise moves the mean by ~1e-4 on the CPU (tests)
    W16 = np.zeros((16, 2), np.float32)
    for name, s, jr in (("bilinear", sim, jref), ("linear", lsim, ljref)):
        o16 = s.fused_runner(ref, steps=STEPS)(spread_X0(16), W16)
        e16 = lane_tracking_error(o16["Yp"], ref)
        log(f"{name} quality B=16: alive "
            f"{o16['alive'][:, -1].float().mean():.4f} err_mean "
            f"{e16.mean():.6f} err_worst {e16.max():.6f} (JAX general "
            f"runner {jr['err_mean']:.6f} / {jr['err_worst']:.6f})")
        if not (bool(o16["alive"].all()) and torch.isfinite(o16["Yp"]).all()
                and abs(e16.mean().item() - jr["err_mean"]) < 1e-3):
            raise AssertionError(f"{name} fused loop quality off the JAX "
                                 f"reference")
    o16 = nsim.batched_runner(ref, steps=STEPS)(spread_X0(16), W16)
    e16 = lane_tracking_error(o16["Yp"], ref)
    log(f"nonlinear (NMPC general runner) quality B=16: alive "
        f"{o16['alive'][:, -1].float().mean():.4f} err_mean "
        f"{e16.mean():.6f} err_worst {e16.max():.6f} (JAX general runner "
        f"{njref['err_mean']:.6f} / {njref['err_worst']:.6f})")
    if not (bool(o16["alive"].all()) and torch.isfinite(o16["Yp"]).all()
            and abs(e16.mean().item() - njref["err_mean"]) < 1e-3):
        raise AssertionError("NMPC loop quality off the JAX reference")

    # ---- phase S2: every SQP regime off the multipass route through its
    # kernels, B=16, 301 steps, against the JAX general runner in that
    # regime (assets/nmpc_regime_refs.json); each run launches as its
    # route does
    regime_refs = json.loads(REGIME_REFS.read_text())["regimes"]
    rsims = {}
    for name, cfg in regime_configs().items():
        rmpc = NonlinearKmpc(nmodel, nscaler, MpcConfig(**cfg), device=dev)
        rsims[name] = rsim = Ksim(arm, rmpc)
        jr = regime_refs[name]
        o16, w16, counts = drive(
            nmpc_launches(rmpc, STEPS),
            lambda: rsim.batched_runner(ref, steps=STEPS)(spread_X0(16),
                                                          W16))
        e16 = lane_tracking_error(o16["Yp"], ref)
        alive16 = o16["alive"][:, -1].float().mean().item()
        log(f"NMPC regime {name} ({rmpc.route} route) quality B=16: alive "
            f"{alive16:.4f} err_mean {e16.mean():.6f} err_worst "
            f"{e16.max():.6f} (JAX general runner {jr['alive']:.4f} "
            f"{jr['err_mean']:.6f} / {jr['err_worst']:.6f}); {w16:.1f} s, "
            f"launches {({k: v for k, v in counts.items() if v})}")
        if not (alive16 == jr["alive"] and torch.isfinite(o16["Yp"]).all()
                and abs(e16.mean().item() - jr["err_mean"]) < 1e-3):
            raise AssertionError(f"NMPC regime {name}: quality off the JAX "
                                 f"reference")

    # ---- phase R2: the bilinear configurations off the lift-fused route
    # through their kernels, B=16, 301 steps, against the JAX general
    # runner in that configuration (assets/bilinear_route_refs.json)
    for name, m in rmpcs.items():
        rs = Ksim(arm, m)
        jr = route_refs[name]
        o16, w16, counts = drive(
            route_launches(m, STEPS),
            lambda: rs.batched_runner(ref, steps=STEPS)(spread_X0(16), W16))
        e16 = lane_tracking_error(o16["Yp"], ref)
        alive16 = o16["alive"][:, -1].float().mean().item()
        log(f"bilinear route {name} quality B=16: alive {alive16:.4f} "
            f"err_mean {e16.mean():.6f} err_worst {e16.max():.6f} (JAX "
            f"general runner {jr['alive']:.4f} {jr['err_mean']:.6f} / "
            f"{jr['err_worst']:.6f}); {w16:.1f} s, launches "
            f"{({k: v for k, v in counts.items() if v})}")
        if not (alive16 == jr["alive"] and torch.isfinite(o16["Yp"]).all()
                and abs(e16.mean().item() - jr["err_mean"]) < 1e-3):
            raise AssertionError(f"bilinear route {name}: quality off the "
                                 f"JAX reference")

    # ---- phases 4, L4: the fused main paths at size, B=262144, 301 steps
    XB, WB = spread_X0(B_MAIN), np.zeros((B_MAIN, 2), np.float32)
    fused_main, fused_rate = {}, {}
    for name, s in (("step_fused", sim), ("linear_step_fused", lsim)):
        run = s.fused_runner(ref, steps=STEPS)
        run(XB[:1024], WB[:1024])                   # warm-up (allocator)
        out, wall, counts = drive({name: STEPS - 1}, lambda: run(XB, WB))
        eB = lane_tracking_error(out["Yp"], ref)
        aliveB = out["alive"][:, -1].float().mean().item()
        log(f"{name} fused main path B={B_MAIN} steps={STEPS}: {wall:.3f} s"
            f" (incl. carry init and reference setup), "
            f"{B_MAIN * (STEPS - 1) / wall:.4e} lane-steps/s, alive "
            f"{aliveB:.6f}, err_mean {eB.mean():.6f}, err_worst "
            f"{eB.max():.6f} | {smi}")
        if aliveB != 1.0 or not torch.isfinite(eB).all():
            raise AssertionError(f"{name} fused main path lost lanes")
        fused_main[name] = counts[name]
        fused_rate[name] = B_MAIN * (STEPS - 1) / wall
        del out

    # ---- phases 5, L5, N5: the general runners at B=65536 (the bilinear
    # runner's depth may be cut to keep the run inside its time limit)
    XG, WG = spread_X0(B_GENERAL), np.zeros((B_GENERAL, 2), np.float32)
    general_main = {}
    for name, s in (("bilin_lift", sim), ("ipm_shared", lsim),
                    ("nmpc_multipass", nsim)):
        grun = s.batched_runner(ref, steps=STEPS)
        s.batched_runner(ref, steps=3)(XB[:1024], WB[:1024])   # warm-up
        gout, gwall, counts = drive({name: STEPS - 1}, lambda: grun(XG, WG))
        eG = lane_tracking_error(gout["Yp"], ref)
        aliveG = gout["alive"][:, -1].float().mean().item()
        log(f"{name} general runner B={B_GENERAL} steps={STEPS}: "
            f"{gwall:.3f} s, {B_GENERAL * (STEPS - 1) / gwall:.4e} "
            f"lane-steps/s, alive {aliveG:.6f}, err_mean {eG.mean():.6f}, "
            f"err_worst {eG.max():.6f} | {smi}")
        if aliveG != 1.0:
            raise AssertionError(f"{name} general runner lost lanes")
        general_main[name] = counts[name]
        del gout

    # ---- phase S3: the stage route (its 'hold'/'roll' modes) and the
    # chord route at B=65536, S3_STEPS steps
    full_main = {}
    for name in FULL_REGIMES:
        rsim = rsims[name]
        grun = rsim.batched_runner(ref, steps=S3_STEPS)
        rsim.batched_runner(ref, steps=3)(XB[:1024], WB[:1024])   # warm-up
        expected = nmpc_launches(rsim.mpc, S3_STEPS)
        gout, gwall, counts = drive(expected, lambda: grun(XG, WG))
        eG = lane_tracking_error(gout["Yp"], ref)
        aliveG = gout["alive"][:, -1].float().mean().item()
        log(f"NMPC regime {name} ({rsim.mpc.route} route) general runner "
            f"B={B_GENERAL} steps={S3_STEPS}: {gwall:.3f} s, "
            f"{B_GENERAL * (S3_STEPS - 1) / gwall:.4e} lane-steps/s, alive "
            f"{aliveG:.6f}, err_mean {eG.mean():.6f}, err_worst "
            f"{eG.max():.6f}, launches {expected} | {smi}")
        if aliveG != 1.0:
            raise AssertionError(f"NMPC regime {name} lost lanes")
        full_main.update({k: counts[k] for k in expected})
        del gout

    # ---- phase R3: iterated relinearization and the unblocked stack at
    # B=65536, S3_STEPS steps
    route_main = {}
    for name in FULL_ROUTES:
        rs = Ksim(arm, rmpcs[name])
        grun = rs.batched_runner(ref, steps=S3_STEPS)
        rs.batched_runner(ref, steps=3)(XB[:1024], WB[:1024])   # warm-up
        expected = route_launches(rmpcs[name], S3_STEPS)
        gout, gwall, counts = drive(expected, lambda: grun(XG, WG))
        eG = lane_tracking_error(gout["Yp"], ref)
        aliveG = gout["alive"][:, -1].float().mean().item()
        log(f"bilinear route {name} general runner B={B_GENERAL} "
            f"steps={S3_STEPS}: {gwall:.3f} s, "
            f"{B_GENERAL * (S3_STEPS - 1) / gwall:.4e} lane-steps/s, alive "
            f"{aliveG:.6f}, err_mean {eG.mean():.6f}, err_worst "
            f"{eG.max():.6f}, launches {expected} | {smi}")
        if aliveG != 1.0:
            raise AssertionError(f"bilinear route {name} lost lanes")
        for k in expected:
            route_main[k] = route_main.get(k, 0) + counts[k]
        del gout

    # ---- phase Q4: the 'linear' update's closed loop at B=65536, 301
    # steps: five launches of ipm_factored's q0 build a step, the explicit
    # condensation and the stage Jacobians in PyTorch between them
    qsim = rsims[LINEAR_REGIME]
    grun = qsim.batched_runner(ref, steps=Q4_STEPS)
    qsim.batched_runner(ref, steps=3)(XB[:1024], WB[:1024])   # warm-up
    expected = nmpc_launches(qsim.mpc, Q4_STEPS)
    gout, lin_wall, counts = drive(expected, lambda: grun(XG, WG))
    eG = lane_tracking_error(gout["Yp"], ref)
    aliveG = gout["alive"][:, -1].float().mean().item()
    log(f"NMPC regime {LINEAR_REGIME} ({qsim.mpc.route} route) general "
        f"runner B={B_GENERAL} steps={Q4_STEPS}: {lin_wall:.3f} s, "
        f"{B_GENERAL * (Q4_STEPS - 1) / lin_wall:.4e} lane-steps/s, alive "
        f"{aliveG:.6f}, err_mean {eG.mean():.6f}, err_worst "
        f"{eG.max():.6f}, launches {expected} | {smi}")
    if aliveG != 1.0:
        raise AssertionError(f"NMPC regime {LINEAR_REGIME} lost lanes")
    lin_main = counts["ipm_factored"]
    del gout

    # ---- phase P: a short torch.profiler window (5 steps at B=65536)
    # on the unblocked route and on the NMPC multipass route, and the two
    # fused main paths whole (B=262144): device time by kernel and the
    # device's idle share
    def profile_window(label, run):
        """Profile ``run`` (a few steps of a main path): each kernel's
        device time, and the idle share 1 - busy / window with busy the
        summed device time of the window's kernels and copies (one
        stream) and the window timed by CUDA events.  The profiler's own
        host overhead is in the window, so the idle share is an upper
        bound.  Without device time from the profiler it says so and
        reports the window alone."""
        from torch.profiler import ProfilerActivity, profile
        run()                                          # warm-up
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_profile_window()
            t0.record()
            run()
            t1.record()
            torch.cuda.synchronize()
        window = t0.elapsed_time(t1)
        by = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            by[e.key] = by.get(e.key, 0.0) + us / 1e3
        busy = sum(by.values())
        if busy <= 0.0:
            log(f"profile {label}: the profiler recorded no device time; "
                f"window {window:.3f} ms (CUDA events), by kernel not "
                f"measured | {smi}")
            return
        top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
        log(f"profile {label}: window {window:.3f} ms, device busy "
            f"{busy:.3f} ms, idle share {1.0 - busy / window:.4f}; by "
            f"kernel: " + "; ".join(f"{k[:60]} {v:.3f} ms "
                                    f"({100 * v / busy:.1f} %)"
                                    for k, v in top) + f" | {smi}")

    for label, s_ in (("unblocked route", Ksim(arm, rmpcs["unblocked"])),
                      ("NMPC multipass route", nsim)):
        prun = s_.batched_runner(ref, steps=6)
        profile_window(f"{label}, B={B_GENERAL}, 5 steps",
                       lambda: prun(XG, WG))
    # the fused main paths of phases 4 and L4 whole, carry init and
    # reference setup included
    for name, s_ in (("step_fused", sim), ("linear_step_fused", lsim)):
        frun = s_.fused_runner(ref, steps=STEPS)
        profile_window(f"{name} fused main path, B={B_MAIN}, {STEPS - 1} "
                       f"steps", lambda: frun(XB, WB))

    # ---- phases 6, L6: each kernel against its plain version, and its
    # time, at its path's shapes
    def launch_split(fn, calls=3) -> str:
        """Device time per call of each launch of a two-launch wrapper
        (the front, then the solve), from torch.profiler over a few
        calls (``device_events``)."""
        ev = device_events(fn, calls)
        if not ev:
            return "front and solve launches not measured (no device " \
                "time from the profiler)"
        return ", ".join(f"{k} {ms:.4f} ms x {n:g}"
                         for k, (ms, n) in sorted(ev.items())
                         if k in names) + " a call (torch.profiler)"

    cB = op.init_carry(XB, WB)
    sf_err = max(sf_err, check_step(op, cB, wins[0],
                                    f"step_fused one step B={B_MAIN}"))
    oB = SF.StepCarry(*(torch.empty_like(t) for t in cB))
    sf_ms = kernel_ms("step_fused",
                      lambda: op.step(cB, wins[0], out=oB), reps=10)
    sf_plain = cuda_ms(lambda: op.step_plain(cB, wins[0]), reps=2, warmup=1)
    sf_flops = (qp_ops(qp, op.iters) + ok_ops(qp.cons) + plant_ops(arm.cfg)
                + step_tail_ops(op, arm.cfg, True)) * B_MAIN
    sf_bytes = carry_bytes(cB) + nbytes(wins[0]) + nbytes(
        qp.gens, qp.rdiag, qp.A, qp.cFr, qp.F0r, qp.Wd, qp.Wo, op.Pwarm)
    sf_bound, sf_by = bound(sf_flops, sf_bytes)
    # breakdown: the QP half alone on the same lanes (the step kernel's
    # remainder is the plant, the freeze and the carry advance)
    qp_ms = kernel_ms("bilin_lift", lambda: BL.bilin_lift_cuda(
        qp, cB.ysc, cB.upsc, cB.x0, cB.lamc, wins[0], op.iters, 1e-2),
        reps=10)
    log(f"breakdown at B={B_MAIN}: QP alone (bilin_lift) {qp_ms:.4f} ms "
        f"of the step's {sf_ms:.4f} ms; by launch "
        f"{launch_split(lambda: op.step(cB, wins[0], out=oB))}; "
        f"{plan_line('step_fused')} | {smi}")
    del cB, oB
    cG = op.init_carry(XG, WG)
    bl_err = max(bl_err, check_bilin(cG, True, wins[0],
                                     f"warm B={B_GENERAL}"))
    ins = (qp, cG.ysc, cG.upsc, cG.x0, cG.lamc, wins[0], op.iters, 1e-2)
    bl_ms = kernel_ms("bilin_lift", lambda: BL.bilin_lift_cuda(*ins),
                      reps=10)
    bl_plain = cuda_ms(lambda: BL.bilin_lift_plain(*ins), reps=2, warmup=1)
    log(f"bilin_lift at B={B_GENERAL}: {bl_ms:.4f} ms; by launch "
        f"{launch_split(lambda: BL.bilin_lift_cuda(*ins))}; "
        f"{plan_line('bilin_lift')} | {smi}")
    bl_flops = qp_ops(qp, op.iters) * B_GENERAL
    bl_bytes = nbytes(cG.ysc, cG.upsc, cG.x0, cG.lamc, wins[0]) \
        + 4 * B_GENERAL * (qp.n + 2 * qp.mc + 1) + nbytes(
            qp.gens, qp.rdiag, qp.A, qp.cFr, qp.F0r, qp.Wd, qp.Wo)
    bl_bound, bl_by = bound(bl_flops, bl_bytes)
    del cG

    lcB = lop.init_carry(XB, WB)
    ls_err = max(ls_err, check_step(lop, lcB, fY[0],
                                    f"linear_step_fused one step "
                                    f"B={B_MAIN}"))
    loB = SF.StepCarry(*(torch.empty_like(t) for t in lcB))
    ls_ms = kernel_ms("linear_step_fused",
                      lambda: lop.step(lcB, fY[0], out=loB), reps=10)
    ls_plain = cuda_ms(lambda: lop.step_plain(lcB, fY[0]), reps=2,
                       warmup=1)
    ls_flops = (linear_grad_ops(lop)
                + mehrotra_ops(cons, lop.iters, nnz(lop.Psh))
                + ok_ops(cons) + plant_ops(arm.cfg)
                + step_tail_ops(lop, arm.cfg, False)) * B_MAIN
    ls_bytes = carry_bytes(lcB) + nbytes(
        fY[0], lop.Psh, lop.G1, lop.P21, lop.cFr, lop.F0r, cons.A, cons.Wd,
        cons.Wo, lop.Pwarm)
    ls_bound, ls_by = bound(ls_flops, ls_bytes)
    # breakdown: the shared-Hessian QP alone on the same lanes' QPs
    Psh, q, b = linear_qp(lcB, 0)
    lqp_ms = kernel_ms("ipm_shared", lambda: IS.ipm_shared_cuda(
        cons, Psh, q, b, lcB.x0, lop.iters, 1e-2), reps=10)
    log(f"breakdown at B={B_MAIN}: QP alone (ipm_shared) {lqp_ms:.4f} ms "
        f"of the linear step's {ls_ms:.4f} ms; by launch "
        f"{launch_split(lambda: lop.step(lcB, fY[0], out=loB))}; "
        f"{plan_line('linear_step_fused')} | {smi}")
    del lcB, loB, q, b
    lcG = lop.init_carry(XG, WG)
    is_err = max(is_err, check_ipm(lcG, 0, f"B={B_GENERAL}"))
    Psh, q, b = linear_qp(lcG, 0)
    ins = (cons, Psh, q, b, lcG.x0, lop.iters, 1e-2)
    is_ms = kernel_ms("ipm_shared", lambda: IS.ipm_shared_cuda(*ins),
                      reps=10)
    is_plain = cuda_ms(lambda: IS.ipm_shared_plain(*ins), reps=2, warmup=1)
    log(f"ipm_shared lane-shared at B={B_GENERAL}: {is_ms:.4f} ms; "
        f"{plan_line('ipm_shared')} | {smi}")
    is_flops = mehrotra_ops(cons, lop.iters, nnz(Psh)) * B_GENERAL
    is_bytes = nbytes(q, b, lcG.x0) + 4 * B_GENERAL * (cons.n + 2 * cons.mc) \
        + nbytes(Psh, cons.A, cons.Wd, cons.Wo)
    is_bound, is_by = bound(is_flops, is_bytes)
    del lcG, q, b

    # ---- phase N6: nmpc_multipass against its plain version and its time
    # at B=65536, on the general path's lanes after 3 steps
    nzG, nuG = nmpc_lanes(B_GENERAL, 3)
    nm_err = max(nm_err, check_nmpc(nzG, nuG, nwins[3], f"B={B_GENERAL}"))
    ins = (nqp, nzG, nuG, nwins[3], *sqp)
    nm_ms = kernel_ms("nmpc_multipass",
                      lambda: NM.nmpc_multipass_cuda(*ins), reps=5)
    nm_plain = cuda_ms(lambda: NM.nmpc_multipass_plain(*ins), reps=1,
                       warmup=1)
    nm_flops = nmpc_ops(nqp, *sqp) * B_GENERAL
    nm_bytes = nbytes(nzG, nuG, nwins[3]) \
        + 4 * B_GENERAL * (nqp.n + 2 * nqp.mc + 1) + nbytes(
            nqp.A1, nqp.A2, nqp.a0, nqp.G, nqp.Gup, nqp.q0c, nqp.CzS,
            nqp.rdiag, nqp.cFr, nqp.F0r, nqp.A, nqp.Wd, nqp.Wo)
    nm_bound, nm_by = bound(nm_flops, nm_bytes)

    # ---- phase S4: nmpc_stage and nmpc_pass against their plain versions
    # and their times at B=65536 on the same lanes, as the full-width
    # routes launch them (a per-lane Levenberg term, cold duals)
    gin = pass_inputs(nzG, nuG, nwins[3])
    ns_err = max(ns_err, check_onepass("nmpc_stage", "roll", gin, False,
                                       f"B={B_GENERAL}"))
    np_err = max(np_err, check_onepass("nmpc_pass", "fresh", gin, False,
                                       f"B={B_GENERAL}"))
    d32 = gin[torch.float32]
    iters = nmpc.cfg.qp_iters
    lane_bytes = nbytes(d32["zeta"], d32["up"], d32["sq"], d32["x0"],
                        d32["q0"]) + 4 * B_GENERAL * (nqp.n + 2 * nqp.mc + 1)
    shared_bytes = nbytes(d32["qp"].rdiag, nqp.CzS, nqp.cFr, nqp.F0r, nqp.A,
                      nqp.Wd, nqp.Wo)
    stage_t = {}
    for mode in N.STAGE_MODES:
        kcall, pcall = onepass("nmpc_stage", mode, d32, False)
        traj = {"ship": (d32["Zl"], d32["Ul"], d32["Fv"]),
                "roll": (d32["Ul"],), "hold": ()}[mode]
        flops = nmpc_onepass_ops(nqp, mode, iters, True, False) * B_GENERAL
        stage_t[mode] = (kernel_ms("nmpc_stage", kcall, reps=10,
                                   build=mode),
                         cuda_ms(pcall, reps=1, warmup=1), flops) + bound(
            flops, lane_bytes + nbytes(*traj) + shared_bytes + nbytes(
                nqp.A1, nqp.A2, nqp.a0, nqp.G))
    # the stage route's launch mix on its main path: one 'hold' and
    # sqp_iters - 1 'roll' launches a step
    mix = {"hold": 1, "roll": rsims[FULL_REGIMES[0]].mpc.cfg.sqp_iters - 1}
    per = lambda i: sum(n * stage_t[m][i] for m, n in mix.items()) \
        / sum(mix.values())
    ns_ms, ns_plain, ns_bound = per(0), per(1), per(3)
    ns_by = stage_t["roll"][4]
    kcall, pcall = onepass("nmpc_pass", "fresh", d32, False)
    np_ms = kernel_ms("nmpc_pass", kcall, reps=10)
    np_plain = cuda_ms(pcall, reps=1, warmup=1)
    np_flops = nmpc_onepass_ops(nqp, "jacobians", iters, True, False) \
        * B_GENERAL
    np_bound, np_by = bound(np_flops, lane_bytes + shared_bytes + 4 * B_GENERAL
                            * nqp.Np * nqp.nz * (nqp.nza + 1))
    log(f"nmpc_stage per mode at B={B_GENERAL} | {smi}: " + "; ".join(
        f"{m} {t[0]:.4f} ms (plain {t[1]:.2f} ms, bound {t[3]:.4f} ms by "
        f"{t[4]}, {t[2] / B_GENERAL:.0f} op/lane; "
        f"{plan_line('nmpc_stage', m)})"
        for m, t in stage_t.items()) + f"; main-path mix {mix}")
    log(f"nmpc_pass at B={B_GENERAL} | {smi}: {np_ms:.4f} ms (plain "
        f"{np_plain:.2f} ms, bound {np_bound:.4f} ms by {np_by}; "
        f"{plan_line('nmpc_pass')})")
    del nzG, nuG, gin, d32

    # ---- phase R4: bilin and each ipm_factored build against their plain
    # versions and their times at B=65536, on closed-loop lanes of each
    # configuration, with the carried duals as the main paths launch them
    route_t = {}
    for name, m in rmpcs.items():
        ins = route_inputs(name, route_lanes(name, B_GENERAL), wins[3], True)
        a32 = ins[torch.float32]
        if m.blocked:
            bi_err = max(bi_err, check_route("bilin", name, ins,
                                             f"warm B={B_GENERAL}"))
            bq, z, up, x0, l0, sq = a32[0][:6]
            flops = qp_ops(bq, m.cfg.qp_iters) * B_GENERAL
            route_t["bilin"] = (
                kernel_ms("bilin", lambda: BI.bilin_cuda(*a32[0]), reps=10),
                cuda_ms(lambda: BI.bilin_plain(*a32[0]), reps=2, warmup=1),
                flops) + bound(flops, nbytes(z, up, x0, l0, sq)
                               + 4 * B_GENERAL * (bq.n + 2 * bq.mc + 1)
                               + nbytes(bq.gens, bq.rdiag, bq.A, bq.cFr,
                                        bq.F0r, bq.Wd, bq.Wo))
            log(f"bilin at B={B_GENERAL}: {route_t['bilin'][0]:.4f} ms; by "
                f"launch {launch_split(lambda: BI.bilin_cuda(*a32[0]))}; "
                f"{plan_line('bilin')} | {smi}")
        if_err = max(if_err, check_route("ipm_factored", name, ins,
                                         f"warm B={B_GENERAL}"))
        fc, rd, Wt, v, b, x0, l0 = a32[1][:7]
        live = (Wt != 0).any(-1).reshape(-1).tolist()
        flops = (gram_ops(live, fc.n)
                 + factored_tail_ops(fc, m.cfg.qp_iters)) * B_GENERAL
        route_t[name] = (
            kernel_ms("ipm_factored", lambda: IF.ipm_factored_cuda(*a32[1]),
                      reps=5, build=name),
            cuda_ms(lambda: IF.ipm_factored_plain(*a32[1]), reps=1,
                    warmup=1),
            flops) + bound(flops, nbytes(Wt, v, b, x0, l0)
                           + 4 * B_GENERAL * (fc.n + 2 * fc.mc + 1)
                           + nbytes(rd, fc.A, fc.Wd, fc.Wo))
        if name == "unblocked":
            uG = {dt: a[1] for dt, a in ins.items()}
        del ins, a32
    log(f"bilinear route kernels at B={B_GENERAL} | {smi}: " + "; ".join(
        f"{'bilin' if k == 'bilin' else 'ipm_factored ' + k} {t[0]:.4f} ms "
        f"(plain {t[1]:.2f} ms, bound {t[3]:.4f} ms by {t[4]}, "
        f"{t[2] / B_GENERAL:.0f} op/lane)" for k, t in route_t.items()))
    bi_ms, bi_plain, _, bi_bound, bi_by = route_t["bilin"]

    # ---- phases Q1, Q2 at size: the q0 build and the per-lane-P build
    # against their plain versions and their times at B=65536, on the
    # 'linear' update's QPs (warm, as Q1) and, per-lane P, the unblocked
    # route's (R4's lanes); each per-lane solve once through the shared-A
    # entry ops/qp.py:solve_qp as its own path
    nzL, nuL = nmpc_lanes(B_GENERAL, 3, qmpc)
    linG = linear_qps(nzL, nuL, nwins[3])
    del nzL, nuL
    dq, dl = check_linear(linG, f"warm B={B_GENERAL}")
    if_err, is_lane_err = max(if_err, dq), max(is_lane_err, dl)
    a32 = linG[torch.float32]
    fc, rd, Wt, v, b, x0, l0, iters, _, q0 = a32
    live = (Wt != 0).any(-1).reshape(-1).tolist()
    flops = (gram_ops(live, fc.n) + fc.n
             + factored_tail_ops(fc, iters)) * B_GENERAL
    route_t[LINEAR_REGIME] = (
        kernel_ms("ipm_factored", lambda: IF.ipm_factored_cuda(*a32),
                  reps=10, build=LINEAR_REGIME),
        cuda_ms(lambda: IF.ipm_factored_plain(*a32), reps=1, warmup=1),
        flops) + bound(flops, nbytes(Wt, v, b, x0, l0, q0)
                       + 4 * B_GENERAL * (fc.n + 2 * fc.mc + 1)
                       + nbytes(rd, fc.A, fc.Wd, fc.Wo))
    lane_t, lane_main, spd = {}, 0, {}
    for key, ins in (("n=12", linG), ("n=27", uG)):
        Pq = {dt: dense_qp(a) for dt, a in ins.items()}
        l32 = lane_p_args(ins[torch.float32], Pq[torch.float32])
        fc, P, q, b, x0, iters, _, iobj, l0 = l32
        if key == "n=27":
            is_lane_err = max(is_lane_err, check_qp(
                "ipm_shared (per-lane P)",
                (IS.ipm_shared_cuda, IS.ipm_shared_plain), l32,
                lane_p_args(ins[torch.float64], Pq[torch.float64]), fc, b,
                f"(unblocked, n=27, mc=108, band 3) warm B={B_GENERAL}")[0])
        n, mc = fc.n, fc.mc
        flops = (n * n + n + 4 * mc
                 + mehrotra_ops(fc, iters, n * n)) * B_GENERAL
        lane_t[key] = (
            kernel_ms("ipm_shared", lambda: IS.ipm_shared_cuda(*l32), reps=5,
                      build="per-lane P " + key),
            cuda_ms(lambda: IS.ipm_shared_plain(*l32), reps=1, warmup=1),
            flops) + bound(flops, nbytes(P, q, b, x0, iobj, l0)
                           + 4 * B_GENERAL * (n + 2 * mc)
                           + nbytes(fc.A, fc.Wd, fc.Wo))
        # the entry's own inputs in original units
        row = fc.row[:, None]
        sol, _, counts = drive({"ipm_shared": 1}, lambda: solve_qp(
            P, Pq[torch.float32][1], fc, b * row, iters, x0=x0,
            lam0=ins[torch.float32][6] / row))
        log(f"ipm_shared (per-lane P) {key} through ops/qp.py:solve_qp, "
            f"B={B_GENERAL}: ok {int(sol.ok.sum())} of {B_GENERAL}; "
            f"{plan_line('ipm_shared lane-P', fc)}")
        if not bool(sol.ok.all()):
            raise AssertionError("solve_qp with a per-lane P lost lanes")
        lane_main += counts["ipm_shared"]
        # phase Q3's systems: the same dense P, q as right-hand sides
        spd[key] = {dt: (P_.permute(2, 0, 1).contiguous(), q_.T.contiguous())
                    for dt, (P_, q_) in Pq.items()}
        del l32, sol, Pq
    del linG, uG, a32

    # ---- phase Q3: batch_chol against its plain version and f64 at
    # B=65536 (n=12: the 'linear' update's dense P; n=27: the unblocked
    # route's), its time, the plain version's and one PyTorch call's
    # (torch.linalg.solve) on the same systems; the two sizes once through
    # the ops-layer entry solve_spd as its own path
    def chol_ops(n: int) -> int:
        """Operations of one system's factor and two substitutions,
        counted from csrc/batch_chol.cu (FMA = 2; sqrt, divide = 1)."""
        return (sum(2 + (n - j) + (n - 1 - j) * (n - j) for j in range(n))
                + 2 * n * (n - 1) + 2 * n)

    chol_t, bc_err = {}, 0.0
    for key, d in spd.items():
        (M, rhs_), (M64, rhs64) = d[torch.float32], d[torch.float64]
        xk = BC.solve_spd_cuda(M, rhs_)
        torch.cuda.synchronize()
        xp = BC.solve_spd_plain(M, rhs_)
        x64 = BC.solve_spd_plain(M64, rhs64)
        scale = x64.abs().amax(1)
        ek = ((xk.double() - x64).abs().amax(1) / scale).max().item()
        ep = ((xp.double() - x64).abs().amax(1) / scale).max().item()
        dx = (xk - xp).abs().max().item()
        log(f"batch_chol {key} B={B_GENERAL}: max|dx| {dx:.3e}; worst "
            f"error relative to the lane's solution: kernel {ek:.3e}, "
            f"plain f32 {ep:.3e}; {plan_line('batch_chol', M.shape[1])}")
        if not (ek <= 2 * ep + 1e-6 and torch.isfinite(xk).all()):
            raise AssertionError("batch_chol kernel disagrees with plain")
        bc_err = max(bc_err, dx)
        n = M.shape[1]
        flops = chol_ops(n) * B_GENERAL
        chol_t[key] = (
            kernel_ms("batch_chol", lambda: BC.solve_spd_cuda(M, rhs_),
                      reps=10, build=key),
            cuda_ms(lambda: BC.solve_spd_plain(M, rhs_), reps=1, warmup=1),
            flops) + bound(flops, nbytes(M, rhs_, xk)) + (
            cuda_ms(lambda: torch.linalg.solve(M, rhs_), reps=10),)
    (M12, r12), (M27, r27) = (spd[k][torch.float32] for k in ("n=12",
                                                               "n=27"))
    xs, _, counts = drive({"batch_chol": 2}, lambda: (
        BC.solve_spd(M12, r12), BC.solve_spd(M27, r27)))
    if not all(bool(torch.isfinite(x).all()) for x in xs):
        raise AssertionError("solve_spd gave non-finite solutions")
    chol_main = counts["batch_chol"]
    log(f"q0 build, per-lane P and batch_chol at B={B_GENERAL} | {smi}: "
        f"(ipm_shared lane-shared {is_ms:.4f} ms) "
        + "; ".join(f"{k} {t[0]:.4f} ms (plain {t[1]:.2f} ms, bound "
                    f"{t[3]:.4f} ms by {t[4]}, {t[2] / B_GENERAL:.0f} "
                    f"op/lane)" + (f", torch.linalg.solve {t[5]:.4f} ms"
                                   if len(t) > 5 else "")
                    for k, t in [("ipm_factored q0",
                                  route_t[LINEAR_REGIME])]
                    + [("ipm_shared per-lane P " + k, t)
                       for k, t in lane_t.items()]
                    + [("batch_chol " + k, t) for k, t in chol_t.items()]))
    del spd, M12, r12, M27, r27, xs
    log(f"{LINEAR_REGIME} at B={B_GENERAL}: {lin_main} q0-build launches "
        f"of {route_t[LINEAR_REGIME][0]:.4f} ms are "
        f"{100 * lin_main * route_t[LINEAR_REGIME][0] / 1e3 / lin_wall:.1f}"
        f" % of the {lin_wall:.3f} s run; the rest is the stage "
        f"Jacobians, the explicit condensation, the plain plant and glue")

    # ipm_factored's main-path mix: the full-width runs' launches, one a
    # step in each of iters2 (n=12) and unblocked (n=27), five a step on
    # the 'linear' route (the q0 build); the launch-weighted mean
    mixf = {"iters2": route_main["ipm_factored"] // 2,
            "unblocked": route_main["ipm_factored"] // 2,
            LINEAR_REGIME: lin_main}
    perf = lambda i: sum(n * route_t[k][i] for k, n in mixf.items()) \
        / sum(mixf.values())
    if_ms, if_plain, if_bound = perf(0), perf(1), perf(3)
    if_by = route_t[LINEAR_REGIME][4]
    # ipm_shared's: the linear general runner's 300 lane-shared launches
    # and the per-lane builds' entry launches (one each)
    sh_n = general_main["ipm_shared"]
    pers = lambda i, base: (sh_n * base + sum(t[i] for t in lane_t.values())
                            ) / (sh_n + len(lane_t))
    is_ms, is_plain, is_bound = (pers(0, is_ms), pers(1, is_plain),
                                 pers(3, is_bound))
    # batch_chol's: one launch at each size
    perc = lambda i: sum(t[i] for t in chol_t.values()) / len(chol_t)
    bc_ms, bc_plain, bc_bound, bc_lib = perc(0), perc(1), perc(3), perc(5)
    bc_by = chol_t["n=27"][4]

    log(f"kernel times | {smi}: step_fused {sf_ms:.4f} ms (plain "
        f"{sf_plain:.2f} ms, bound {sf_bound:.4f} ms by {sf_by}, "
        f"{sf_flops / B_MAIN:.0f} op/lane) at B={B_MAIN}; bilin_lift "
        f"{bl_ms:.4f} ms (plain {bl_plain:.2f} ms, bound {bl_bound:.4f} ms "
        f"by {bl_by}, {bl_flops / B_GENERAL:.0f} op/lane) at B={B_GENERAL}; "
        f"linear_step_fused {ls_ms:.4f} ms (plain {ls_plain:.2f} ms, bound "
        f"{ls_bound:.4f} ms by {ls_by}, {ls_flops / B_MAIN:.0f} op/lane) at "
        f"B={B_MAIN}; ipm_shared {is_ms:.4f} ms (plain {is_plain:.2f} ms, "
        f"bound {is_bound:.4f} ms by {is_by}; main-path mix: the linear "
        f"general runner's and one per-lane-P launch at n=12 and n=27) at "
        f"B={B_GENERAL}; nmpc_multipass {nm_ms:.4f} ms (plain "
        f"{nm_plain:.2f} ms, bound {nm_bound:.4f} ms by {nm_by}, "
        f"{nm_flops / B_GENERAL:.0f} op/lane) at B={B_GENERAL}; nmpc_stage "
        f"{ns_ms:.4f} ms (plain {ns_plain:.2f} ms, bound {ns_bound:.4f} ms "
        f"by {ns_by}; main-path mix) at B={B_GENERAL}; nmpc_pass "
        f"{np_ms:.4f} ms (plain {np_plain:.2f} ms, bound {np_bound:.4f} ms "
        f"by {np_by}, {np_flops / B_GENERAL:.0f} op/lane) at B={B_GENERAL}; "
        f"bilin {bi_ms:.4f} ms (plain {bi_plain:.2f} ms, bound "
        f"{bi_bound:.4f} ms by {bi_by}) at B={B_GENERAL}; ipm_factored "
        f"{if_ms:.4f} ms (plain {if_plain:.2f} ms, bound {if_bound:.4f} ms "
        f"by {if_by}; main-path mix {mixf}) at B={B_GENERAL}; batch_chol "
        f"{bc_ms:.4f} ms (plain {bc_plain:.2f} ms, bound {bc_bound:.4f} ms "
        f"by {bc_by}, torch.linalg.solve {bc_lib:.4f} ms; n=12 and n=27 "
        f"mean) at B={B_GENERAL}")

    # ---- phase T: train the three models on the card from the committed
    # corpus, hold them to the CPU's training and to the committed assets,
    # and close the loop with them through the kernels
    phase_training(dev, drive, arm, ref, spread_X0, fused_rate, smi)
    arm.clear_graphs()          # the bench arm's periods: no phase after T

    # ---- phases LS, RS: the lasso sweep from the corpus to the closed
    # loop (its per-lane-P ipm_shared launches join row 4's main path),
    # and the random-system sweep at the reference's scale
    ls = phase_lasso_sweep(dev, drive, check_qp, kernel_ms, smi)
    phase_rand_models(dev, smi)

    # ---- phase LD: the loaded-arm experiment from its corpus to the
    # closed loop with the load observer (its bilin and ipm_shared
    # launches join rows 5 and 4)
    ld = phase_loaded(dev, drive, check_qp, ptx, Lx, smi)

    # ---- phase DX: every dictionary from training to the closed loop
    # (its bilin_lift, bilin, nmpc_pass, ipm_factored and ipm_shared
    # launches join rows 2, 8, 7, 9 and 4)
    dx = phase_dictionaries(dev, drive, check_qp, ptx, Dx, smi)
    dxl = lambda kernel: sum(v for k, v in dx["launches"].items()
                             if Dx.paths[k].kernel == kernel)

    # ---- phase RN: the harness in full, the fused step on the default
    # plant and on angle outputs, the controller knobs (its step_fused,
    # linear_step_fused, ipm_shared and bilin_lift launches join rows 1,
    # 3, 4 and 2)
    def plan_of(so) -> str:
        plan = so.launch_plan()
        return (f"plan: group {plan.group}, {plan.threads} threads and "
                f"{plan.lanes} lanes a block, "
                f"{plan.min_blocks or 'no bound on'} blocks an SM; ptxas: "
                + ptx(so.kernel_spec()))

    rn = phase_runners(dev, types.SimpleNamespace(
        drive=drive, carry_after=carry_after, check_step=check_step,
        check_qp=check_qp, kernel_ms=kernel_ms, plan_of=plan_of,
        timed_sims={"linear": lsim, "bilinear": sim, "nonlinear": nsim}),
        Rx, Dx, smi)
    rnl = rn["launches"]

    # ---- phase NU: the NMPC's unblocked stack in every route and its
    # state bounds, loaded models with delays (its nmpc_multipass,
    # nmpc_stage, nmpc_pass, ipm_factored, bilin and ipm_shared launches
    # join rows 6, 7, 8, 4, 5 and 4)
    nu = phase_unblocked(dev, types.SimpleNamespace(
        drive=drive, kernel_ms=kernel_ms, ptx=ptx, log=log, arm=arm,
        spread_X0=spread_X0), Ux, smi)

    # ---- phase GN: the arm plant in full and data generation without
    # JAX (its step_fused and bilin_lift launches join rows 1 and 2)
    gn = phase_generation(dev, types.SimpleNamespace(
        drive=drive, log=log, spread_X0=spread_X0), smi)

    tpu = "koopman_realizations_tpu/ops/pallas/"
    src = "koopman_realizations_torch/csrc/"
    rows = [("step_fused", "step_fused.py:90", fused_main["step_fused"],
             sf_err, sf_ms, sf_plain, sf_bound, sf_by),
            ("bilin_lift", "qp_ipm.py:772",
             general_main["bilin_lift"] + dxl("bilin_lift"),
             max(bl_err, dx["builds"]["del1"]["err"]), bl_ms, bl_plain,
             bl_bound, bl_by),
            ("linear_step_fused", "step_fused.py:185",
             fused_main["linear_step_fused"], ls_err, ls_ms, ls_plain,
             ls_bound, ls_by),
            ("ipm_shared", "qp_ipm.py:299",
             general_main["ipm_shared"] + lane_main + ls["launches"]
             + sum(ld["launches"]["ipm_shared"].values())
             + dxl("ipm_shared"),
             max(is_err, is_lane_err, ls["err"], ld["ipm_shared"]["err"],
                 ld["observer n=2"]["err"], ld["observer n=1"]["err"]),
             is_ms, is_plain, is_bound, is_by),
            ("nmpc_multipass", "qp_ipm.py:1422",
             general_main["nmpc_multipass"], nm_err, nm_ms, nm_plain,
             nm_bound, nm_by),
            ("nmpc_stage", "qp_ipm.py:1560", full_main["nmpc_stage"], ns_err,
             ns_ms, ns_plain, ns_bound, ns_by),
            ("nmpc_pass", "qp_ipm.py:1144",
             full_main["nmpc_pass"] + dxl("nmpc_pass"),
             max([np_err] + [dx["builds"][k]["err"]
                             for k in ("nmpc-fs1", "nmpc-bilin")]),
             np_ms, np_plain, np_bound, np_by),
            ("bilin", "qp_ipm.py:998",
             route_main["bilin"] + ld["launches"]["bilin"] + dxl("bilin"),
             max([bi_err, ld["bilin"]["err"]]
                 + [dx["builds"][k]["err"] for k in ("nopca", "fs1")]),
             bi_ms, bi_plain, bi_bound, bi_by),
            ("ipm_factored", "qp_ipm.py:299",
             route_main["ipm_factored"] + lin_main + dxl("ipm_factored"),
             if_err, if_ms, if_plain, if_bound, if_by),
            ("batch_chol", "batch_chol.py:28", chol_main, bc_err, bc_ms,
             bc_plain, bc_bound, bc_by)]
    # the two-launch wrappers count calls, each a front (or sweep) launch
    # and a solve launch on the device: device_launches_per_call is the
    # profiler's count in one call of each wrapper (kernel_ms)
    kernels = [{"name": name, "route": "cuda", "source": src + name + ".cu",
                "replaces": tpu + tpu_at, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bms, "bound_by": by,
                "library_ms": bc_lib if name == "batch_chol" else None,
                "device_launches_per_call": launches_per_call(name)}
               for name, tpu_at, launches, err, ms, plain, bms, by in rows]
    # ipm_shared's ms, plain_ms and bound_ms stay those of its launches at
    # B=65536; the lasso sweep's launches at B = its lanes, counted in
    # its launches, are timed on their own
    next(k for k in kernels if k["name"] == "ipm_shared")["lasso_sweep"] = {
        "launches": ls["launches"], "ms": ls["ms"], "plain_ms": ls["plain"],
        "bound_ms": ls["bound"], "bound_by": ls["by"]}
    # the loaded experiment's builds (phase LD, B=2048): their launches
    # are in their rows' launches, timed on their own; their device
    # launches a call counted by the profiler over 20 steps of the loops
    # (the linear loop's lane-shared and observer calls together)
    def sub(entry, launches, per):
        return {"launches": launches, "max_abs_err": entry["err"],
                "ms": entry["ms"], "plain_ms": entry["plain"],
                "bound_ms": entry["bound"], "bound_by": entry["by"],
                "device_launches_per_call": ld["per_call"].get(per)}
    ldl = ld["launches"]["ipm_shared"]
    next(k for k in kernels if k["name"] == "bilin")["loaded"] = sub(
        ld["bilin"], ld["launches"]["bilin"], "bilin")
    next(k for k in kernels if k["name"] == "ipm_shared")["loaded"] = {
        "lane_shared_n8": sub(ld["ipm_shared"], Lx.refs["steps"] - 1,
                              "linear/True"),
        "observer_n2": sub(ld["observer n=2"], ldl["bilinear/True"],
                           "bilinear/True"),
        "observer_n1": sub(ld["observer n=1"], ldl["linear/True"]
                           - (Lx.refs["steps"] - 1), "linear/True")}
    # phase DX's new builds (B_GENERAL): their launches on the DX paths
    # are in their rows' launches, their times of their own
    for name, bd in dx["builds"].items():
        row = next(k for k in kernels if k["name"] == bd["kernel"])
        row.setdefault("dictionaries", {})[name] = {
            "launches": dx["launches"][name], "max_abs_err": bd["err"],
            "ms": bd["ms"], "plain_ms": bd["plain"],
            "bound_ms": bd["bound"], "bound_by": bd["by"]}
    # phase RN's new builds: their launches on the RN paths are in their
    # rows' launches, their times of their own
    rn_rows = {"step_fused": ("default_bilinear", "angles_bilinear"),
               "linear_step_fused": ("default_linear", "angles_linear"),
               "ipm_shared": ("linear_dual_warm", "linear_dual_shift",
                              "linear_unblocked_sb", "lasso_iters2",
                              "lasso_iters2 full"),
               "bilin_lift": ("bilinear_dual_shift",)}
    for kname, paths in rn_rows.items():
        row = next(k for k in kernels if k["name"] == kname)
        row["launches"] += sum(rnl.get(p, 0) for p in paths)
    for name, f in rn["fused"].items():
        row = next(k for k in kernels if k["name"] == f["kernel"])
        row.setdefault("substep", {})[name] = {
            "launches": rnl[name], "max_abs_err": f["err"], "ms": f["ms"],
            "plain_ms": f["plain"], "bound_ms": f["bound"],
            "bound_by": f["by"], "plant_front_bound_ms": f["plant_bound"]}
    row = next(k for k in kernels if k["name"] == "ipm_shared")
    for label, f in rn["ipm_shared"].items():
        row.setdefault("harness_builds", {})[label] = {
            "launches": {"warm n=12": rnl["linear_dual_warm"]
                         + rnl["linear_dual_shift"],
                         "n=27 dense": rnl["linear_unblocked_sb"]}.get(
                             label, 0),
            "max_abs_err": f["err"], "ms": f["ms"], "plain_ms": f["plain"],
            "bound_ms": f["bound"], "bound_by": f["by"]}
    # phase NU's builds: their launches on the NU paths join their rows'
    # launches, their times of their own
    for path, counts in nu["launches"].items():
        for kname, n in counts.items():
            if not n:
                continue
            row = next(k for k in kernels if k["name"] == kname)
            row["launches"] += n
            row.setdefault("unblocked_launches", {})[path] = n
    for name, bd in nu["builds"].items():
        row = next(k for k in kernels if k["name"] == bd["kernel"])
        row.setdefault("unblocked", {})[name] = {
            "max_abs_err": bd["err"], "ms": bd["ms"],
            "plain_ms": bd["plain"], "bound_ms": bd["bound"],
            "bound_by": bd["by"]}
    for kname, n in gn["launches"].items():
        row = next(k for k in kernels if k["name"] == kname)
        row["launches"] += n
        row["generation_launches"] = n
    log("RN comp_time (ms a step, B=1): " + json.dumps(rn["comp_time"])
        + f"; RN6 bilin_lift del1 p99 to f64 kernel/plain f32 "
          f"{rn['tail']['p99']}, f32 tail {rn['tail']['f32_tail']}")
    log("device launches a wrapper call (torch.profiler, each build's "
        "first timing): " + ", ".join(
            f"{k} {v}" for k, v in dev_launches.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# ---- measurements beside the smoke run (``python3 chip_smoke.py
# --measure NAME --out FILE``); each writes its report to FILE (JSON) and
# prints a summary line with the card's name and power limit
# the DX3 lanes whose card readings lay outside JAX's f32 band (ROADMAP.md
# §3, open check 1)
BAND_LANES = {"del1": (0,), "nmpc-fs1": (4, 9)}
# the linear state-bound knob with cold duals at 24 iterations and the
# bounds the loop's outputs never reach (the outputs' range widened by
# 2.0, tests/test_torch_oracle.py:KNOB_Y_RANGE), the configuration that
# lost lanes at B_GENERAL (``measure_cold_lanes``)
# the far steps of a shadowed loop whose inputs ``measure_shadow`` keeps
SHADOW_KEEP = 12
COLD_SB = dict(qp_dual_warm=False, qp_iters=24, state_bounds=tuple(
    (lo - 2.0, hi + 2.0) for lo, hi in (
        (-0.243, 0.145), (0.228, 0.333), (-0.148, 0.451), (0.370, 0.666),
        (-0.19, 0.704), (0.14, 0.9995))))


def band_copy(model, k: int):
    """Copy k of ``model`` for a 96-copy f32 band (the JAX writers' recipe,
    tests/test_torch_oracle.py): every nonzero of its f32 A (W of a
    nonlinear model) one ulp up or down, the directions from
    ``numpy.random.default_rng([0, k])``; copy 0 is the model."""
    import dataclasses

    import numpy as np
    name = "W" if hasattr(model, "W") else "A"
    A = np.asarray(getattr(model, name), np.float32)
    if k == 0:
        return model
    up = np.random.default_rng([0, k]).random(A.shape) < 0.5
    Ak = np.where(A == 0, A, np.nextafter(
        A, np.where(up, np.inf, -np.inf).astype(np.float32)))
    return dataclasses.replace(model, **{name: Ak})


def band_runs(path: str, k0: int, k1: int, device: str) -> list:
    """[[alive, err_mean] per lane] of copies k0..k1-1 of a DX path: its
    controller (the refs' qp_iters) through the general runner on the
    refs' 16 lanes over 301 blockM steps."""
    import torch

    from koopman_realizations_torch.config import ArmConfig
    from koopman_realizations_torch.control.kmpc import make_kmpc
    from koopman_realizations_torch.control.ksim import KoopmanPlant, Ksim
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.utils.checkpoint import load_model
    from koopman_realizations_torch.utils.metrics import lane_tracking_error
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    if device == "cpu":
        torch.set_num_threads(1)
    refs = json.loads(DICT_REFS.read_text())
    r = refs["paths"][path]
    model, scaler, _ = load_model(DICT_REFS.parent / r["asset"])
    cfg = dict_config(r)
    arm = Arm(ArmConfig(**ARM), device=device)
    ref = blockM_reference()
    out = []
    for k in range(k0, k1):
        mk = band_copy(model, k)
        P = types.SimpleNamespace(r=r, model=mk,
                                  mpc=make_kmpc(mk, scaler, cfg,
                                                device=device))
        plant = KoopmanPlant(mk, scaler, device) if r["plant"] == "model" \
            else arm
        res = Ksim(plant, P.mpc, device=device).batched_runner(
            ref, steps=refs["steps"])(*dict_lanes(P, refs["B"]))
        e = lane_tracking_error(res["Yp"], ref).cpu().numpy()
        alive = res["alive"][:, -1].cpu().numpy()
        out.append([[bool(a), float(v)] for a, v in zip(alive, e)])
    return out


def band_judge(reports: list) -> dict:
    """Open check 1 from band reports (``measure_f32_band``, one a
    device).  For each lane of ``BAND_LANES`` each device's copy-0
    reading, the band of its copies 1..N-1 (copy 0 left out: it is the
    reading judged), copy 0's rank among them (0: below all), and JAX's
    band beside the x64 value.  For each path and device over all its
    lanes: how many copy-0 readings lie outside JAX's band, the share of
    copies 1..N-1 that do, the chance of that many or more at that share
    (binomial), and where a card and a CPU report are both given, each
    lane's rank-sum p-value of the two devices' copies 1..N-1 (lanes
    whose JAX band is wider than CHAOTIC_BAND)."""
    import numpy as np
    from scipy.stats import binom, mannwhitneyu
    jrefs = json.loads(DICT_REFS.read_text())["paths"]
    runs = lambda rep, path: np.asarray(
        [[v for _, v in ls] for ls in rep["paths"][path]["lanes"]])
    out = {}
    for path in {p_ for rep in reports for p_ in rep["paths"]}:
        jr = jrefs[path]
        jb = np.asarray(jr["f32"]["band"])
        outside = lambda e: (e < jb[:, 0]) | (e > jb[:, 1])
        per = {rep["device"]: runs(rep, path) for rep in reports
               if path in rep["paths"]}
        for i in BAND_LANES.get(path, ()):
            row = {"jax_band": jb[i].tolist(), "jax_x64": jr["err_mean"][i]}
            for dev, e in per.items():
                c0, rest = float(e[0, i]), e[1:, i]
                row[dev] = {"copy0": c0, "band_1": [float(rest.min()),
                                                    float(rest.max())],
                            "rank0": int((rest < c0).sum()), "of": len(rest),
                            "inside_jax": not bool(outside(e[0])[i])}
            out[f"{path} lane {i}"] = row
        whole = {}
        for dev, e in per.items():
            n0, share = int(outside(e[0]).sum()), float(outside(e[1:]).mean())
            whole[dev] = {"copy0_outside": n0, "lanes": e.shape[1],
                          "copies_outside_share": share,
                          "p_this_many": float(binom.sf(n0 - 1, e.shape[1],
                                                        share))}
        if {"cuda", "cpu"} <= set(per):
            wide = np.nonzero(jb[:, 1] - jb[:, 0] > CHAOTIC_BAND)[0]
            whole["rank_sum_p"] = {
                str(i): float(mannwhitneyu(per["cuda"][1:, i],
                                           per["cpu"][1:, i]).pvalue)
                for i in wide}
        out[path] = whole
    return out


def measure_f32_band(out: Path, device: str, paths, copies: int,
                     procs: int, judge_only=()) -> dict:
    """The port's own 96-copy f32 band of the ``BAND_LANES`` paths on
    ``device`` (copies split over ``procs`` processes), or with
    ``judge_only`` the judgement of earlier reports alone."""
    import numpy as np
    reports = [json.loads(Path(f).read_text()) for f in judge_only]
    if not judge_only:
        rep = {"device": device, "copies": copies, "paths": {}}
        for path in paths:
            t0 = time.perf_counter()
            bounds = np.linspace(0, copies, max(1, procs) + 1).astype(int)
            procs_ = [subprocess.Popen(
                [sys.executable, __file__, "--measure", "band-chunk",
                 "--device", device, "--paths", path, "--copies",
                 f"{a},{b}"], stdout=subprocess.PIPE, text=True)
                for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
            lanes = []
            for pr in procs_:
                so, _ = pr.communicate()
                if pr.returncode:
                    raise RuntimeError(f"f32 band: a chunk of {path} failed")
                lanes += json.loads(so.strip().splitlines()[-1])
            rep["paths"][path] = {"lanes": lanes,
                                  "seconds": time.perf_counter() - t0}
        reports = [rep]
    return {"reports": reports, "judge": band_judge(reports)}


def lane_cols(args: tuple, idx) -> tuple:
    """``ipm_shared`` arguments of the lanes ``idx`` alone (the per-lane
    operands' columns; the shared P and rows as they are)."""
    import torch
    return tuple(t[:, idx].contiguous() if torch.is_tensor(t) and i > 1
                 and t.ndim == 2 else t for i, t in enumerate(args))


def cast_args(args: tuple, dtype, device) -> tuple:
    """``ipm_shared`` arguments (rows included) in ``dtype`` on
    ``device``."""
    import torch

    from koopman_realizations_torch.ops.qp import Constraints
    t_ = lambda t: t.to(device, dtype) if torch.is_tensor(t) else t
    return (Constraints(*(t_(t) for t in args[0])),) + tuple(
        t_(t) for t in args[1:])


def lost_lane_solves(args32) -> dict:
    """The lost lanes' QPs (``ipm_shared`` arguments exactly as the loop
    solved them, f32) solved by the kernel, its plain version in f32 on
    the card and on the CPU and in f64 (the same QPs cast), each at the
    loop's iterations and at twice them, and f64 at 100: {solver: {"ok",
    "gap", "rp": the primal residual over its limit, "finite"}} a lane."""
    import torch

    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.ops.qp import ok_mask, qp_constants

    def judged(fn, a, iters):
        a = a[:5] + (iters,) + a[6:]
        x, s, lam = fn(*a)
        cons, b = a[0], a[3]
        c = qp_constants(b.dtype)
        ok, gap = ok_mask(cons, b, x, s, lam, c.tol, c.gap_sane)
        rp = torch.clamp(cons.A @ x - b, min=0.0).amax(0) \
            / (c.tol * torch.clamp(b.abs().amax(0), min=1.0))
        return {"ok": ok.cpu().tolist(), "gap": gap.cpu().tolist(),
                "rp": rp.cpu().tolist(),
                "finite": torch.isfinite(x).all(0).cpu().tolist()}

    it = args32[5]
    dev = args32[2].device
    cpu32 = cast_args(args32, torch.float32, "cpu")
    a64 = cast_args(args32, torch.float64, dev)
    out = {}
    for k in (it, 2 * it):
        out[f"kernel f32 {k}"] = judged(IS.ipm_shared_cuda, args32, k)
        out[f"plain f32 {k} (card)"] = judged(IS.ipm_shared_plain, args32,
                                              k)
        out[f"plain f32 {k} (cpu)"] = judged(IS.ipm_shared_plain, cpu32, k)
        out[f"plain f64 {k}"] = judged(IS.ipm_shared_plain, a64, k)
    out["plain f64 100"] = judged(IS.ipm_shared_plain, a64, 100)
    return out


def measure_cold_lanes(out: Path, device: str = "cuda",
                       B: int = B_GENERAL, steps: int = STEPS,
                       plain: bool = False, knob: bool = False) -> dict:
    """The linear unblocked state-bound knob with ``COLD_SB`` (cold duals,
    24 iterations, the wide bounds) on B lanes x ``steps`` through the
    general runner: the lanes that die, the step each dies at and whether
    its QP failed there (or the plant).  Each solve's ``ipm_shared``
    arguments are kept as the loop solves them (``LinearKmpc.qp_args``);
    at a step where lanes die the kernel runs again on the whole batch
    (does it fail them again, and are its results bitwise those of the
    loop's launch?) and on the lost lanes alone, and every solver of
    ``lost_lane_solves`` takes the lost lanes' QPs.  Those QPs go to
    ``out`` with the suffix .npz (f32, the kernel's arguments).  With
    ``plain`` the loop solves its QPs by the kernel's plain version on
    the same device instead (its lost lanes alone are reported); with
    ``knob`` the loop runs the knob's own configuration (warm duals, 16
    iterations, the capped bounds) in place of ``COLD_SB``."""
    import numpy as np
    import torch

    from koopman_realizations_torch.config import ArmConfig
    from koopman_realizations_torch.control.kmpc import make_kmpc
    from koopman_realizations_torch.control.ksim import Ksim, _Loop
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.ops.kernels import _build
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.ops.qp import QPSolution, ok_mask
    from koopman_realizations_torch.utils.checkpoint import load_model
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    dev = torch.device(device)
    r = json.loads(KNOB_REFS.read_text())["paths"]["linear_unblocked_sb"]
    cfg = rn_config(dict(r["config"], **({} if knob else COLD_SB)))
    model, scaler, _ = load_model(KNOB_REFS.parent / r["asset"])
    m32 = make_kmpc(model, scaler, cfg, device=dev)
    if dev.type == "cuda":
        _build.build_all([IS.kernel_spec(m32.constraints(),
                                         warm=cfg.qp_dual_warm)])
    sim = Ksim(Arm(ArmConfig(**ARM), device=dev), m32, device=dev)
    ref = blockM_reference()
    X0 = np.zeros((B, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B)
    windows = sim.reference_windows(ref, steps)
    loop = _Loop(sim, steps, windows, sim._ref_rows(sim.prep_ref(ref),
                                                    steps), (), X0,
                 np.zeros((B, 2), np.float32))
    seen = {}

    def recorded(*a):
        # LinearKmpc.solve, its arguments kept
        seen["args"] = m32.qp_args(*a)
        if plain:
            # solve_shared_operands with the plain version on the card
            args, obj = seen["args"]
            x, s_, lam = IS.ipm_shared_plain(*args)
            ok, gap = ok_mask(args[0], args[3], x, s_, lam, 3e-3, 5e-2)
            x = torch.where(torch.isfinite(x).all(0), x,
                            torch.full_like(x, float("nan")))
            sol = QPSolution(x, lam * obj / args[0].row[:, None], ok, gap)
        else:
            sol = IS.solve_shared_operands(*seen["args"])
        seen["sol"] = sol
        return m32.plan(a[1], sol.x), sol

    m32.solve = recorded
    lost, reruns, qps = [], [], []
    t0 = time.perf_counter()
    try:
        for k in range(steps - 1):
            before = loop.alive
            loop.step(k)
            idx = torch.nonzero(before & ~loop.alive)[:, 0]
            if not len(idx):
                continue
            sol, (args, _) = seen["sol"], seen["args"]
            lost += [{"lane": int(i), "step": k,
                      "qp_ok": bool(sol.ok[i])} for i in idx]
            if dev.type == "cuda" and not plain:
                x1, s1, l1 = IS.ipm_shared_cuda(*args)
                ok1 = ok_mask(args[0], args[3], x1, s1, l1, 3e-3, 5e-2)[0]
                xl = IS.ipm_shared_cuda(*lane_cols(args, idx))
                okl = ok_mask(args[0], args[3][:, idx], *xl, 3e-3, 5e-2)[0]
                same = lambda u, v: (u == v) | (u.isnan() & v.isnan())
                reruns.append({
                    "step": k, "lanes": idx.tolist(),
                    "loop_ok": sol.ok[idx].tolist(),
                    "rerun_ok": ok1[idx].tolist(),
                    "alone_ok": okl.tolist(),
                    "rerun_lanes_not_bitwise": int((~same(
                        x1, sol.x)).any(0).sum()),
                    "rerun_ok_flips": int((ok1 != sol.ok).sum())})
            qps.append(lane_cols(args, idx))
    finally:
        del m32.solve
    wall = time.perf_counter() - t0
    rep = {"config": dataclasses_dict(cfg), "B": B, "steps": steps,
           "solver": "plain" if plain else "kernel", "wall_s": wall,
           "alive": float(loop.alive.float().mean()), "lost": lost,
           "reruns": reruns}
    if qps and dev.type == "cuda" and not plain:
        cat = lambda j: torch.cat([q[j] for q in qps], 1)
        a32 = (qps[0][0], qps[0][1], cat(2), cat(3), cat(4)) \
            + qps[0][5:]
        rep["solves"] = lost_lane_solves(a32)
        cons = a32[0]
        np.savez(out.with_suffix(".npz"), header=json.dumps(
            {"config": rep["config"], "lost": lost, "B": B,
             "iters": a32[5], "slack_floor": a32[6],
             "written_by": "python3 chip_smoke.py --measure cold-lanes"}),
            Psh=a32[1].cpu().numpy(), q=a32[2].cpu().numpy(),
            b=a32[3].cpu().numpy(), x0=a32[4].cpu().numpy(),
            A=cons.A.cpu().numpy(), row=cons.row.cpu().numpy())
    return rep


def measure_qp_trace(out: Path, qps: Path, device: str = "cuda") -> dict:
    """The lost lanes' QPs of ``measure_cold_lanes`` (its .npz) solved by
    the kernel and by its plain version in f32 on the card, each stopped
    after 1, 2, ... 2 x the loop's iterations: every iterate (x, s, lam)
    to ``out`` with the suffix .npz, and each one's gap and step from the
    previous iterate in the report."""
    import numpy as np
    import torch

    from koopman_realizations_torch.control.kmpc import make_kmpc
    from koopman_realizations_torch.ops.kernels import _build
    from koopman_realizations_torch.ops.kernels import ipm_shared as IS
    from koopman_realizations_torch.utils.checkpoint import load_model
    d = np.load(qps)
    h = json.loads(str(d["header"]))
    r = json.loads(KNOB_REFS.read_text())["paths"]["linear_unblocked_sb"]
    model, scaler, _ = load_model(KNOB_REFS.parent / r["asset"])
    m = make_kmpc(model, scaler, rn_config(h["config"]), device=device)
    cons = m.constraints()
    if not np.array_equal(cons.A.cpu().numpy(), d["A"]):
        raise AssertionError("qp-trace: the rows are not the lost lanes'")
    t = lambda k: torch.as_tensor(d[k], device=device).contiguous()
    base = (cons, t("Psh"), t("q"), t("b"), t("x0"))
    if device == "cuda":
        _build.build_all([IS.kernel_spec(cons)])
    saved, rep = {}, {}
    solvers = (("kernel", IS.ipm_shared_cuda),) if device == "cuda" else ()
    for name, fn in solvers + (("plain", IS.ipm_shared_plain),):
        gaps = []
        for k in range(1, 2 * h["iters"] + 1):
            x, s_, lam = fn(*base, k, h["slack_floor"])
            saved.update({f"{name}/{k}/x": x.cpu().numpy(),
                          f"{name}/{k}/s": s_.cpu().numpy(),
                          f"{name}/{k}/lam": lam.cpu().numpy()})
            gaps.append(((s_ * lam).sum(0) / cons.mc).cpu().tolist())
        rep[name] = {"gap": gaps}
    np.savez(out.with_suffix(".npz"), **saved)
    return rep


def dataclasses_dict(cfg) -> dict:
    import dataclasses
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def measure_shadow(out: Path, device: str = "cuda", steps: int = STEPS,
                   paths=tuple(BAND_LANES)) -> dict:
    """Open check 1's else-branch: where the card's DX3 loops of
    ``BAND_LANES`` part from plain f32.  Each path's general runner runs
    on the refs' 16 lanes through its kernel (loop A), every solve's
    inputs also solved by the path's controller on the CPU in f32 (the
    plain versions) and in f64: per step and lane the plan distances
    |U_kernel - U_f64| and |U_plain - U_f64|.  Loop B is the same card
    loop with the CPU's plain f32 solve in place of the kernel's.  A step
    where the kernel's plan is farther from f64 than 4x plain f32's plus
    1e-5 is one where the kernel parts from plain f32."""
    import numpy as np
    import torch

    from koopman_realizations_torch.config import ArmConfig
    from koopman_realizations_torch.control.kmpc import make_kmpc
    from koopman_realizations_torch.control.ksim import KoopmanPlant, Ksim
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.ops.kernels import _build
    from koopman_realizations_torch.utils.checkpoint import load_model
    from koopman_realizations_torch.utils.metrics import lane_tracking_error
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    dev = torch.device(device)
    refs = json.loads(DICT_REFS.read_text())
    arm = Arm(ArmConfig(**ARM), device=dev)
    ref = blockM_reference()
    D = dict_setup(dev, arm)
    if dev.type == "cuda":
        _build.build_all([D.specs[p] for p in paths])
    cast = lambda a, dt: [t.to("cpu", dt) if torch.is_tensor(t) and
                          t.is_floating_point() else t for t in a]
    rep, saved = {}, {}
    for path in paths:
        P = D.paths[path]
        model, scaler, _ = load_model(DICT_REFS.parent / P.r["asset"])
        c32, c64 = (make_kmpc(model, scaler, P.cfg, device="cpu", dtype=dt)
                    for dt in (torch.float32, torch.float64))
        B, L = refs["B"], list(BAND_LANES[path])
        X0, W = dict_lanes(P, B)
        run = P.sim.batched_runner(ref, steps=steps)
        solve, dk, dp, far_in = P.mpc.solve, [], [], []
        # the shadow solves take the checked lanes alone
        lanes_of = lambda a: [t[..., L].contiguous() if torch.is_tensor(t)
                              and t.ndim > 1 and t.shape[-1] == B else t
                              for t in a]

        def shadowed(*a):
            U, sol = solve(*a)
            U64 = c64.solve(*cast(lanes_of(a), torch.float64))[0]
            U32 = c32.solve(*cast(lanes_of(a), torch.float32))[0]
            dk.append((U[:, L].cpu().double() - U64).abs().amax(0))
            dp.append((U32.double() - U64).abs().amax(0))
            if ((dk[-1] > 4 * dp[-1] + 1e-5).any()
                    and len(far_in) < SHADOW_KEEP):
                far_in.append((len(dk) - 1, lanes_of(a), U[:, L].cpu(),
                               U32, U64))
            return U, sol

        def plain(*a):
            U, sol = c32.solve(*cast(a, torch.float32))
            return U.to(dev), type(sol)(*(t.to(dev) for t in sol))

        t0 = time.perf_counter()
        try:
            P.mpc.solve = shadowed
            resA = run(X0, W)
            P.mpc.solve = plain
            resB = run(X0, W)
        finally:
            del P.mpc.solve
        dk, dp = torch.stack(dk).numpy(), torch.stack(dp).numpy()
        yA, yB = (r_["Yp"].cpu().numpy() for r_ in (resA, resB))
        eA, eB = (lane_tracking_error(r_["Yp"], ref).cpu().numpy()
                  for r_ in (resA, resB))
        aA, aB = (r_["alive"].cpu().numpy() for r_ in (resA, resB))
        lanes = {}
        for j, i in enumerate(L):
            live = aA[i] & aB[i]
            far = (dk[:, j] > 4 * dp[:, j] + 1e-5) & live
            pfar = (dp[:, j] > 4 * dk[:, j] + 1e-5) & live
            gap = np.abs(yA[i] - yB[i]).max(-1)
            first = lambda m: int(np.argmax(m)) if m.any() else None
            lanes[str(i)] = {
                "err_mean": {"kernel": float(eA[i]), "plain": float(eB[i])},
                "alive": {"kernel": bool(aA[i, -1]),
                          "plain": bool(aB[i, -1])},
                "plan_to_f64": {"kernel_max": float(dk[live, j].max()),
                                "plain_max": float(dp[live, j].max()),
                                "kernel_median": float(
                                    np.median(dk[live, j])),
                                "plain_median": float(
                                    np.median(dp[live, j]))},
                "kernel_far_steps": np.nonzero(far)[0].tolist(),
                "plain_far_steps": np.nonzero(pfar)[0].tolist(),
                "loops_part_1e-4": first(gap > 1e-4),
                "loops_part_1e-2": first(gap > 1e-2),
                "kernel_to_f64": dk[:, j].tolist(),
                "plain_to_f64": dp[:, j].tolist()}
        rep[path] = {"lanes": lanes, "seconds": time.perf_counter() - t0,
                     "far": [{"step": k, "kernel_to_f64": (
                         Uk.double() - U64).abs().amax(0).tolist(),
                         "plain_to_f64": (U32.double() - U64).abs().amax(
                             0).tolist()} for k, _, Uk, U32, U64 in far_in]}
        if P.kernel == "bilin_lift" and dev.type == "cuda":
            rep[path]["trace"] = [lift_trace(P, a) for _, a, *_ in far_in]
        saved.update({f"{path}/s{k}/a{n}": t.cpu().numpy()
                      for k, a, *_ in far_in
                      for n, t in enumerate(a) if torch.is_tensor(t)})
        saved.update({f"{path}/s{k}/{nm}": t.numpy()
                      for k, _, *Us in far_in
                      for nm, t in zip(("U_kernel", "U_plain", "U_f64"),
                                       Us)})
    if saved:
        np.savez(out.with_suffix(".npz"), **saved)
    return rep


def lift_trace(P, a) -> dict:
    """One far step's ``bilin_lift`` solve (lane-sliced solve arguments
    ``a`` on the card: zeta, u_prev, sqYr, U_plan, lam) at 1, 2 and 4
    times the loop's iterations by the kernel, plain f32 and f64: each
    one's distance to f64 at 4 times (the max over its plan), and the
    smallest slack of each at the loop's count and of f64 at 4 times."""
    import torch

    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    it = P.cfg.qp_iters
    args = {}
    for dt, m in ((torch.float32, P.mpc), (torch.float64, P.mpc64)):
        z, up, sq, U = (t.to(dt) for t in a[:4])
        lam = m.shift_lam(a[4].to(dt)) if len(a) > 4 else None
        qp = m.lift_qp()
        args[dt] = lambda k, qp=qp, z=z, up=up, sq=sq, U=U, lam=lam, m=m: (
            qp, z, up, m.warm_start(U).contiguous(),
            None if lam is None else (lam * qp.row[:, None]).contiguous(),
            sq, k, 1e-2)
    ref = BL.bilin_lift_plain(*args[torch.float64](4 * it))
    far = lambda r: (r[0].double() - ref[0]).abs().amax(0).tolist()
    out = {}
    for k in (it, 2 * it, 4 * it):
        out[str(k)] = {
            "kernel": far(BL.bilin_lift_cuda(*args[torch.float32](k))),
            "plain": far(BL.bilin_lift_plain(*args[torch.float32](k))),
            "f64": far(BL.bilin_lift_plain(*args[torch.float64](k)))}
    slack = lambda r: r[1].amin(0).tolist()
    out["smallest_slack"] = {
        "kernel": slack(BL.bilin_lift_cuda(*args[torch.float32](it))),
        "plain": slack(BL.bilin_lift_plain(*args[torch.float32](it))),
        "f64_converged": slack(ref)}
    return out


def measure_time_general(out: Path) -> dict:
    """The general runner's wall time (CUDA events) at B_GENERAL x STEPS
    for four configurations of the smoke run: the bilinear bench
    controller (``bilin_lift``), the NMPC on its multipass route, the
    stage route's damping_decay regime and the bilinear iters2 route
    (``bilin``, ``ipm_factored``), each once after a warm-up.  Only
    entry points that earlier trees share, so that a copy of this file
    in an unpacked parent commit times the parent's runner."""
    import numpy as np
    import torch

    from koopman_realizations_torch.config import ArmConfig, MpcConfig
    from koopman_realizations_torch.control.kmpc import (
        BilinearKmpc,
        NonlinearKmpc,
    )
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.ops import nmpc as N
    from koopman_realizations_torch.ops.kernels import _build
    from koopman_realizations_torch.ops.kernels import bilin as BI
    from koopman_realizations_torch.ops.kernels import bilin_lift as BL
    from koopman_realizations_torch.ops.kernels import ipm_factored as IF
    from koopman_realizations_torch.ops.kernels import nmpc_multipass as NM
    from koopman_realizations_torch.ops.kernels import nmpc_stage as NS
    from koopman_realizations_torch.utils.checkpoint import (
        NONLINEAR_MODEL,
        load_model,
    )
    from koopman_realizations_torch.utils.trajectories import (
        blockM_reference,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model, scaler, _ = load_model()
    nmodel, nscaler, _ = load_model(NONLINEAR_MODEL)
    arm = Arm(ArmConfig(**ARM), device=dev)
    knobs = json.loads(ROUTE_REFS.read_text())["regimes"]["iters2"]["knobs"]
    mpcs = {
        "bilin_lift": BilinearKmpc(model, scaler, MpcConfig(**MPC),
                                   device=dev),
        "nmpc_multipass": NonlinearKmpc(nmodel, nscaler,
                                        MpcConfig(**NMPC_MPC), device=dev),
        "damping_decay": NonlinearKmpc(
            nmodel, nscaler, MpcConfig(**regime_configs()["damping_decay"]),
            device=dev),
        "iters2": BilinearKmpc(model, scaler, MpcConfig(**{**MPC, **knobs}),
                               device=dev)}
    nqp = mpcs["nmpc_multipass"].nmpc_qp()
    it2 = mpcs["iters2"]
    _build.build_all([BL.kernel_spec(mpcs["bilin_lift"].lift_qp()),
                      NM.kernel_spec(nqp)]
                     + [NS.kernel_spec(nqp, mode) for mode in N.STAGE_MODES]
                     + [BI.kernel_spec(it2.bilin_qp()),
                        IF.kernel_spec(it2.constraints(), it2.p)])
    ref = blockM_reference()
    X0 = np.zeros((B_GENERAL, 6), np.float32)
    X0[:, 0] = np.linspace(-0.2, 0.2, B_GENERAL)
    W = np.zeros((B_GENERAL, 2), np.float32)
    rep = {}
    for name, m in mpcs.items():
        sim = Ksim(arm, m)
        run = sim.batched_runner(ref, steps=STEPS)
        sim.batched_runner(ref, steps=3)(X0[:1024], W[:1024])   # warm-up
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        res = run(X0, W)
        t1.record()
        torch.cuda.synchronize()
        rep[name] = {"s": t0.elapsed_time(t1) / 1e3,
                     "alive": float(res["alive"][:, -1].float().mean())}
        del res
    return rep


def measure_plant_rhs(out: Path) -> dict:
    """A replayed control period of the 'rk4', 'stage' and 'rk45' plants
    (``assets/plant_refs.json``'s arms, f32) at B_GENERAL and at 16 lanes,
    integrating ``arm_lanes.rhs_lanes`` (the plants' RHS) or ``rhs_soa``
    on the state's rows, stacked: the same closed form as the SDIRK2
    plant's.  Order soa, lanes, lanes, soa, each from a fresh capture;
    CUDA events over 5 replays after the capture.  Also the largest
    |lanes - soa| of a period."""
    import torch

    from koopman_realizations_torch.config import ArmConfig
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.models.arm_lanes import make_rhs_tuple

    def soa_rhs(arm):
        def lane_rhs(U, W):
            f = make_rhs_tuple(arm.cfg, arm.G_host, arm.b_host, list(U),
                               W[0], W[1])
            return lambda X: torch.stack(f(*X))
        return lane_rhs

    rep = {}
    refs = json.loads(PLANT_REFS.read_text())
    for name, r in refs["plants"].items():
        arm = Arm(ArmConfig(**r["arm"]), device="cuda")
        lanes_rhs = arm.lane_rhs
        for B in (B_GENERAL, REF_LANES):
            X, U, W = plant_lanes(arm, B)
            ms = {"soa": [], "lanes": []}
            outs = {}
            for rhs in ("soa", "lanes", "lanes", "soa"):
                arm.lane_rhs = soa_rhs(arm) if rhs == "soa" else lanes_rhs
                arm.clear_graphs()
                outs[rhs] = arm.step(X, U, W)
                ms[rhs].append(cuda_ms(lambda: arm.step(X, U, W), reps=5,
                                       warmup=0))
            d = (outs["lanes"] - outs["soa"]).abs().max().item()
            rep[f"{name} B={B}"] = {"soa_ms": ms["soa"],
                                    "lanes_ms": ms["lanes"],
                                    "max_abs_lanes_vs_soa": d}
            log(f"plant-rhs {name} B={B}: a period soa {ms['soa']} ms, "
                f"lanes {ms['lanes']} ms; |lanes - soa| {d:.3e}")
        arm.clear_graphs()
    return rep


def measure(argv) -> int:
    """``--measure NAME --out FILE [--device D] [--paths P ...]
    [--copies N | K0,K1] [--procs N] [--judge FILE ...]``: NAME one of
    f32-band, cold-lanes, qp-trace, shadow, time-general, plant-rhs (and
    band-chunk, one process's copies of f32-band)."""
    import argparse
    ap = argparse.ArgumentParser(prog="chip_smoke.py --measure")
    ap.add_argument("name", choices=("f32-band", "band-chunk", "cold-lanes",
                                     "qp-trace", "shadow", "time-general",
                                     "plant-rhs"))
    ap.add_argument("--qps", help="qp-trace: cold-lanes' .npz")
    ap.add_argument("--plain", action="store_true",
                    help="cold-lanes: the loop on the plain version")
    ap.add_argument("--knob", action="store_true",
                    help="cold-lanes: the knob's own configuration")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", nargs="*", default=list(BAND_LANES))
    ap.add_argument("--copies", default="96")
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--judge", nargs="*", default=())
    ap.add_argument("--lanes", type=int, default=B_GENERAL)
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.name == "band-chunk":
        k0, k1 = (int(v) for v in a.copies.split(","))
        print(json.dumps(band_runs(a.paths[0], k0, k1, a.device)))
        return 0
    if a.device == "cuda" and not a.judge and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    out = Path(a.out)
    t0 = time.perf_counter()
    if a.name == "f32-band":
        rep = measure_f32_band(out, a.device, a.paths, int(a.copies),
                               a.procs, a.judge)
    elif a.name == "cold-lanes":
        rep = measure_cold_lanes(out, a.device, a.lanes, a.steps, a.plain,
                                 a.knob)
    elif a.name == "qp-trace":
        rep = measure_qp_trace(out, Path(a.qps), a.device)
    elif a.name == "shadow":
        rep = measure_shadow(out, a.device, a.steps, a.paths)
    elif a.name == "plant-rhs":
        rep = measure_plant_rhs(out)
    else:
        rep = measure_time_general(out)
    smi = smi_line() if a.device == "cuda" and not a.judge else "cpu"
    rep = {"measure": a.name, "smi": smi, "seconds":
           time.perf_counter() - t0, "report": rep}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep) + "\n")
    brief = {k: v for k, v in rep["report"].items() if k not in
             ("reports", "solves")} if isinstance(rep["report"], dict) \
        else rep["report"]
    print(f"{a.name}: {json.dumps(brief)[:4000]} | {smi}", flush=True)
    return 0



if __name__ == "__main__":
    sys.exit(measure(sys.argv[2:]) if sys.argv[1:2] == ["--measure"]
             else main())
