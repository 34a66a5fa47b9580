"""EDMD / Koopman-realization training (port of ``models/edmd.py:47-398``
of the JAX package, reference class ``Ksysid``).

The pipeline mirrors the reference constructor (``Ksysid.m:37-144``):
dims -> observable dictionary -> merge trials -> fit the [-1,1] scaling ->
snapshot pairs -> PCA dimension reduction -> least-squares Koopman
operator per lasso value -> linear / bilinear / nonlinear model ->
validation rollouts.

Where each stage runs: merging, scaling and snapshot extraction are host
numpy f64, exactly as in the JAX package.  Lifting, PCA, regression,
extraction and validation run on ``device`` (the card unless the caller
asks for the CPU), the lift and the models in ``cfg.dtype``, PCA and the
regression in f64.  f32 matmuls run at full precision (TF32 off) whatever
the caller's setting.  The models come back as the port's containers
holding host numpy in ``cfg.dtype``, which is what the controllers take.

Ported: discrete and continuous time (the generator logm(K' + 1e-12 I)
/ Ts on the host in f64, ``ops/linalg.py:logm_host``), plain least
squares (lasso inf) and the LASSO path (finite lasso: FISTA in f64 on the
device, ``ops/lasso.py``, with the delay pin mask), every observable
family and mixed lists of them, with or without PCA, with delays, with
loads (``cfg.loaded``: the lifted state [g; w1 g; ...], NL = N (nw + 1),
from trials that carry ``w``; with delays, g of the delay-embedded zeta
and each pair's load at its time) or without, from the trials' snapshot
pairs or from the pre-extracted pairs a datafile carries
(``DataSet.snapshots``, JAX ``edmd.py:85-90``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import List, Optional

import numpy as np
import torch

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.config import SysidConfig
from koopman_realizations_torch.models.koopman import (
    BilinearModel,
    LinearModel,
    ModelMeta,
    NonlinearModel,
    rollout,
)
from koopman_realizations_torch.ops.lasso import lasso_fista_f64
from koopman_realizations_torch.ops.linalg import (
    logm_host,
    pcs_for_explained,
)
from koopman_realizations_torch.ops.lstsq import lstsq
from koopman_realizations_torch.ops.observables import (
    KoopmanBasis,
    build_basis,
    delay_embed,
)
from koopman_realizations_torch.ops.scaling import Scaler, fit_scaler
from koopman_realizations_torch.types import (
    DataSet,
    SnapshotPairs,
    Trial,
    merge_trials,
)
from koopman_realizations_torch.utils.metrics import get_error
from koopman_realizations_torch.utils.timing import DeviceClock

STAGES = ("data", "lift", "pca", "regression", "extraction", "validation")


def _least_squares(lasso: float) -> bool:
    """True where the JAX trainer fits by plain least squares."""
    return lasso >= 1e6 or math.isinf(lasso)


def _full_f32(method):
    """Run ``method`` with f32 matmuls at full precision (no TF32), the
    caller's setting restored afterwards."""
    @functools.wraps(method)
    def wrapper(*args, **kw):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return method(*args, **kw)
        finally:
            torch.set_float32_matmul_precision(prev)
    return wrapper


class StageClock:
    """Time spent in each training stage (``DeviceClock`` marks, read
    once at the end)."""

    def __init__(self, device: torch.device):
        self.clock = DeviceClock(device)
        self.spans: dict = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        start = self.clock.mark()
        yield
        self.spans.setdefault(stage, []).append((start, self.clock.mark()))

    def ms(self) -> dict:
        """{stage: milliseconds} summed over each stage's spans."""
        return {k: sum(self.clock.ms(a, b) for a, b in v)
                for k, v in self.spans.items()}


class Ksysid:
    """Koopman system identification from trial data, on ``device``."""

    @_full_f32
    def __init__(self, data: DataSet, cfg: SysidConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        first = data.train[0]
        self.n, self.m, self.Ts = first.n, first.m, first.Ts
        if cfg.loaded and first.w is None:
            raise ValueError("loaded=True but training data has no load "
                             "field (w)")
        self.nw = first.w.shape[1] if cfg.loaded else 0
        self.nd = cfg.delays
        self.nzeta = self.n * (self.nd + 1) + self.m * self.nd
        self.isfake = data.isfake
        self.sys_params = data.params
        self.clock = StageClock(self.device)
        self.basis: KoopmanBasis = build_basis(cfg, self.n, self.m,
                                               nw=self.nw)

        # merge + scale (Ksysid.m:119-131) and snapshot pairs (:134)
        with self.clock("data"):
            merged = merge_trials(data.train)
            self.scaler: Scaler = fit_scaler(merged)
            self.traindata = self.scaler.trial_down(merged)
            self.valdata = [self.scaler.trial_down(tr) for tr in data.val]
            # a datafile may carry pre-extracted pairs (Ksysid.m:931-938)
            if data.snapshots is not None:
                sp = data.snapshots
                self.snapshot_pairs = SnapshotPairs(
                    alpha=np.asarray(sp["alpha"]),
                    beta=np.asarray(sp["beta"]), u=np.asarray(sp["u"]),
                    w=np.asarray(sp["w"]) if "w" in sp else None)
            else:
                self.snapshot_pairs = self.get_snapshot_pairs(
                    self.traindata, cfg.snapshots)
        self._lifted = None

        # PCA dimension reduction (Ksysid.m:137-142)
        if cfg.dim_red:
            with self.clock("lift"):
                Px_full = self.full_lift()
            with self.clock("pca"):
                pcs = pcs_for_explained(Px_full, cfg.pca_explained)
            self.basis = self.basis.with_pcs(pcs.cpu().numpy())

        self.N = self.basis.N
        self.candidates: List = []
        self.model = None
        # lasso value -> each finite-lasso fit's FISTA iterations,
        # objective, milliseconds to its stop, budget and free L1 norm
        self.lasso_stats: dict = {}

    # ------------------------------------------------------------------ data

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def get_snapshot_pairs(self, data: Trial, num: float) -> SnapshotPairs:
        """Snapshot pairs of merged time series (``Ksysid.m:910-984``),
        host numpy f64, with each pair's load w for a loaded model.  Pairs
        straddling trial boundaries are dropped
        (before.t < after.t); then ``num_max = P-1`` pairs are sampled
        without replacement (so with snapshots=inf the last pair is left
        out, as in the reference), a finite ``num`` by a numpy Generator
        seeded with ``cfg.seed``."""
        zeta, uzeta = delay_embed(data.y, data.u, self.nd)
        t = np.asarray(data.t)
        good = t[self.nd:-1] < t[self.nd + 1:]
        alpha = zeta[:-1][good]
        beta = zeta[1:][good]
        u = uzeta[:-1][good]
        w = None
        if self.nw > 0:
            w = np.asarray(data.w)[self.nd:][:-1][good]
        num_max = alpha.shape[0] - 1
        k = num_max if not math.isfinite(num) else min(int(num), num_max)
        if k < num_max:
            rng = np.random.default_rng(self.cfg.seed)
            idx = rng.choice(num_max, size=k, replace=False)
        else:
            idx = np.arange(num_max)
        return SnapshotPairs(alpha=alpha[idx], beta=beta[idx], u=u[idx],
                             w=None if w is None else w[idx])

    def _dimred_inputs(self) -> np.ndarray:
        """Rows fed to the full lift for PCA (``Ksysid.lift_snapshots``)."""
        sp = self.snapshot_pairs
        if self.cfg.model_type == "nonlinear":
            return np.concatenate([sp.alpha, sp.u], axis=1)
        return np.asarray(sp.alpha)

    @_full_f32
    def full_lift(self) -> torch.Tensor:
        """The full (pre-PCA) basis of the PCA's input rows, (K, N_full)
        in ``cfg.dtype`` on the device."""
        rows = self._on_device(self._dimred_inputs())
        return self.basis.lift_full(rows.T).T

    # ------------------------------------------------------ operator fitting

    @_full_f32
    def lift_snapshot_matrices(self):
        """The regression matrices (Px, Py), (K, cols) on the device
        (``Ksysid.m:1013-1065``), memoized, with NL = N*(nw+1) (psi the
        loaded lift for a loaded model):
        - linear:    [psi(zeta), u]       (NL + m columns)
        - nonlinear: psi([zeta, u])       (NL columns)
        - bilinear:  psi_input(zeta, u)   (NL*(m+1) columns)
        """
        if self._lifted is not None:
            return self._lifted
        with self.clock("lift"):
            sp, b = self.snapshot_pairs, self.basis
            alpha = self._on_device(sp.alpha).T
            beta = self._on_device(sp.beta).T
            u = self._on_device(sp.u).T
            mt = self.cfg.model_type
            if self.nw > 0:
                w = self._on_device(sp.w).T
                lift = lambda z: b.lift_loaded(z, w)
                lift_input = lambda z: b.lift_loaded_input(z, w, u)
            else:
                lift, lift_input = b.lift, lambda z: b.lift_input(z, u)
            if mt == "nonlinear":
                Px = lift(torch.cat([alpha, u]))
                Py = lift(torch.cat([beta, u]))
            elif mt == "bilinear":
                Px, Py = lift_input(alpha), lift_input(beta)
            else:
                Px = torch.cat([lift(alpha), u])
                Py = torch.cat([lift(beta), u])
            self._lifted = (Px.T, Py.T)
        return self._lifted

    def _lstsq(self, A, B) -> torch.Tensor:
        """Minimum-norm least squares in f64, cast to ``cfg.dtype``.

        An f32 lift truncates at rcond = f32 eps (the JAX ``_lstsq64``,
        numpy ``lstsq``'s cutoff): singular directions below the f32 noise
        floor of the features are noise, and their huge coefficients make
        rho(A) > 1 once the model is cast to f32.  An f64 lift takes the
        JAX ``lstsq``'s default cutoff, eps64 * max(shape).
        """
        rcond = (None if self.dtype == torch.float64
                 else float(torch.finfo(torch.float32).eps))
        return lstsq(A, B, rcond=rcond).to(self.dtype)

    def _delay_pin_mask(self, Nm: int) -> Optional[np.ndarray]:
        """Entries of K pinned to 1 by the delay structure
        (``Ksysid.solve_KoopmanQP:1139-1164``, JAX ``edmd.py:221-244``):
        K[:, j] predicts basis entry j at the next step, and delayed
        entries are exact copies of current ones, so those columns are
        unit vectors.  Linear models with delays only."""
        if self.cfg.model_type != "linear" or self.nd < 1:
            return None
        n, m, nd, NL = self.n, self.m, self.nd, self.NL
        mask = np.zeros((Nm, Nm), bool)
        for j in range(1, nd + 1):          # y-delay blocks
            dst = n * j + np.arange(n)
            src = n * (j - 1) + np.arange(n)
            mask[src, dst] = True
        for j in range(1, nd + 1):          # u-delay blocks
            dst = n * (nd + 1) + m * (j - 1) + np.arange(m)
            if j == 1:
                src = NL + np.arange(m)     # current input columns of Px
            else:
                src = n * (nd + 1) + m * (j - 2) + np.arange(m)
            mask[src, dst] = True
        return mask

    def _koop(self, K) -> dict:
        Px, Py = self.lift_snapshot_matrices()
        return {"K": K, "Px": Px[:, :self.NL], "Py": Py[:, :self.NL],
                "u": self._on_device(self.snapshot_pairs.u)}

    @_full_f32
    def get_koopman(self, lasso: float) -> dict:
        """K with Px K ~= Py (``Ksysid.get_Koopman:987-1092``): least
        squares, or for a finite lasso the L1-constrained fit
        (``lasso_koopmans``)."""
        if not _least_squares(lasso):
            return self.lasso_koopmans((lasso,))[lasso]
        Px, Py = self.lift_snapshot_matrices()
        with self.clock("regression"):
            K = self._lstsq(Px, Py)
        return self._koop(K)

    @_full_f32
    def lasso_koopmans(self, values) -> dict:
        """lasso -> the ``get_koopman`` dict of each finite value: the
        L1-constrained fit of budget lasso * N (``Ksysid.m:994-999``) by
        FISTA in f64 on the device, capped at ``cfg.lasso_iters`` and
        stopped by ``cfg.lasso_tol``, every value one fit of a single
        batched run on the memoized lift, each stopped on its own (the
        JAX trainer fits them one after another, each by the same
        steps).  Records ``lasso_stats``."""
        Px, Py = self.lift_snapshot_matrices()
        pin = self._delay_pin_mask(Px.shape[1])
        t = [lv * self.N for lv in values]
        with self.clock("regression"):
            res = lasso_fista_f64(Px, Py, t, pin_mask=pin,
                                  iters=self.cfg.lasso_iters,
                                  tol=self.cfg.lasso_tol)
        pinned = 0.0 if pin is None else float(pin.sum())
        free = res.K if pin is None else torch.where(
            torch.as_tensor(pin, device=res.K.device),
            torch.zeros_like(res.K), res.K)
        l1 = free.abs().sum((-2, -1)).cpu().numpy()
        out = {}
        for i, lv in enumerate(values):
            self.lasso_stats[lv] = {
                "iters": int(res.iters[i]),
                "objective": float(res.objective[i]),
                "ms": float(res.ms[i]), "budget": t[i] - pinned,
                "free_l1": float(l1[i])}
            out[lv] = self._koop(res.K[i].to(self.dtype))
        return out

    # ------------------------------------------------------ model extraction

    def _meta(self) -> ModelMeta:
        return ModelMeta(
            model_type=self.cfg.model_type, time_type=self.cfg.time_type,
            n=self.n, m=self.m, nd=self.nd, nw=self.nw, N=self.N,
            nzeta=self.nzeta, Ts=self.Ts)

    @property
    def NL(self) -> int:
        """The lifted state's dimension N*(nw+1)."""
        return self.N * (self.nw + 1)

    def _C(self) -> np.ndarray:
        """y = C z: the first n entries of the lifted state."""
        return np.eye(self.n, self.NL, dtype=np.dtype(self.cfg.dtype))

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    @property
    def continuous(self) -> bool:
        return self.cfg.time_type == "continuous"

    def _generator(self, K: torch.Tensor) -> torch.Tensor:
        """logm(K + 1e-12 I) / Ts of a fitted operator (``Ksysid.m:
        1186-1190``): on the host in f64, then in ``cfg.dtype`` on the
        device."""
        Kc = logm_host(self._host(K) + 1e-12 * np.eye(K.shape[0])) / self.Ts
        return self._on_device(Kc)

    def _UT(self, K: torch.Tensor) -> torch.Tensor:
        """K^T, or its generator for a continuous model."""
        return self._generator(K.T) if self.continuous else K.T

    @_full_f32
    def get_model(self, koop) -> LinearModel:
        """A, B, C and the projection M (``Ksysid.get_model:1179-1235``):
        M = argmin ||L M^T - Py|| with L_i = (A Px_i + B u_i)^T, folded in
        (A, B = M A, M B) for a discrete model; a continuous one keeps the
        generators."""
        K, NL = koop["K"], self.NL
        UT = self._UT(K)
        A, B = UT[:NL, :NL], UT[:NL, NL:]
        L = koop["Px"] @ A.T + koop["u"] @ B.T
        M = self._lstsq(L, koop["Py"]).T
        if not self.continuous:
            A, B = M @ A, M @ B
        h = self._host
        return LinearModel(A=h(A), B=h(B), C=self._C(), M=h(M),
                           K=h(K), meta=self._meta(), basis=self.basis)

    def get_BLmodel(self, koop) -> BilinearModel:
        """A, B (stored (NL, m, NL): block k multiplies input k), C
        (``Ksysid.get_BLmodel:1238-1282``)."""
        K, NL = koop["K"], self.NL
        UT = self._UT(K)
        h = self._host
        return BilinearModel(A=h(UT[:NL, :NL]),
                             B=h(UT[:NL, NL:].reshape(NL, self.m, NL)),
                             C=self._C(), K=h(K), meta=self._meta(),
                             basis=self.basis)

    def get_NLmodel(self, koop) -> NonlinearModel:
        """The vector field W = K[:, :nzeta] (of the generator
        logm(K + 1e-12 I) / Ts for a continuous model), C = I
        (``Ksysid.get_NLmodel:1298-1341``)."""
        K = self._generator(koop["K"]) if self.continuous else koop["K"]
        return NonlinearModel(W=self._host(K[:, :self.nzeta]),
                              C=np.eye(self.n, dtype=np.dtype(self.cfg.dtype)),
                              K=self._host(K), meta=self._meta(),
                              basis=self.basis)

    @_full_f32
    def train_models(self, lasso=None) -> "Ksysid":
        """One candidate model per lasso value (``Ksysid.m:1344-1389``),
        every candidate on the one memoized lift, the finite values in
        one batched FISTA run (``lasso_koopmans``)."""
        lasso_vals = self.cfg.lasso if lasso is None else (
            (lasso,) if np.isscalar(lasso) else tuple(lasso))
        extract = {"linear": self.get_model, "bilinear": self.get_BLmodel,
                   "nonlinear": self.get_NLmodel}[self.cfg.model_type]
        finite = [float(v) for v in lasso_vals
                  if not _least_squares(float(v))]
        koops = self.lasso_koopmans(tuple(dict.fromkeys(finite))) \
            if finite else {}
        self.candidates = []
        for lv in lasso_vals:
            lv = float(lv)
            koop = koops[lv] if lv in koops else self.get_koopman(lv)
            with self.clock("extraction"):
                mdl = dataclasses.replace(extract(koop), lasso=lv)
            self.candidates.append(mdl)
        self.model = self.candidates[0]
        return self

    # ----------------------------------------------------------- validation

    @_full_f32
    def val_model(self, model, valtrial: Trial) -> dict:
        """Open-loop rollout against a held-out trial (``Ksysid.val_*model``,
        scaled trials of ``self.valdata``): {t, sim: {y, z}, real: {y},
        error}, the rollout on the device (a loaded model's under the
        trial's scaled loads)."""
        zeta, uz = delay_embed(valtrial.y, valtrial.u, self.nd)
        yreal = np.asarray(valtrial.y)[self.nd:]
        zeta0 = self._on_device(zeta[:1].T)
        W = None
        if self.nw > 0:
            W = self._on_device(np.asarray(valtrial.w)[self.nd:])
        if isinstance(model, NonlinearModel):
            z0 = zeta0
        elif W is None:
            z0 = self.basis.lift(zeta0)
        else:
            z0 = self.basis.lift_loaded(zeta0, W[:1].T)
        Y, Z = rollout(model, z0[:, 0], self._on_device(uz), W)
        return {"t": np.asarray(valtrial.t)[self.nd:],
                "sim": {"y": self._host(Y), "z": self._host(Z)},
                "real": {"y": yreal},
                "error": get_error(Y, yreal, scaler=self.scaler)}

    def validate(self, model=None) -> list:
        """``val_model`` over every validation trial (``valNplot_model``)."""
        model = model or self.model
        with self.clock("validation"):
            return [self.val_model(model, tr) for tr in self.valdata]

    def stage_ms(self) -> dict:
        """Milliseconds spent in each stage of ``STAGES`` so far."""
        return self.clock.ms()
