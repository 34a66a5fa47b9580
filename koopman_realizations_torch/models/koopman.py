"""Koopman model containers of the port (``models/koopman.py`` of the JAX
package): the linear realization z+ = A z + B u and the bilinear one
z+ = A z + Beta(z) u with Beta(z) = einsum('kmj,j->km', B, z), both with
y = C z, and the nonlinear one zeta+ = W^T g([zeta; u]); and their
open-loop rollouts (``rollout``, with loads or without).  A continuous-time
model holds the generators of the same maps (z' = A z + B u, ...): its
rollouts step a linear model by its exact zero-order-hold discretization
(``zoh_discretize`` / ``as_discrete``), a bilinear one by RK4 (8 substeps)
or by the exact u-dependent exponential (``zoh_step_bilinear``), a
nonlinear one by RK4 (JAX ``models/koopman.py:128-314``).

A model comes from the port's trainer (``models.edmd.Ksysid``) or from
the JAX trainer's arrays (``from_jax_arrays``), both usually through the
``.npz`` handoff format (``utils.checkpoint``).  Arrays stay host numpy
here; the controller turns what it needs into device buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from koopman_realizations_torch import resolve_device
from koopman_realizations_torch.ops.integrators import rk4
from koopman_realizations_torch.ops.observables import (
    KoopmanBasis,
    kron_ones,
)
from koopman_realizations_torch.ops.scaling import Scaler


@dataclasses.dataclass(frozen=True)
class ModelMeta:
    """Static metadata shared by all model types (reference ``params``)."""

    model_type: str
    time_type: str
    n: int
    m: int
    nd: int
    nw: int
    N: int
    nzeta: int
    Ts: float

    @property
    def NL(self) -> int:
        return self.N * (self.nw + 1)


@dataclasses.dataclass(frozen=True, eq=False)
class LinearModel:
    """z+ = A z + B u; B is (NL, m)."""

    A: Any
    B: Any
    C: Any
    meta: ModelMeta
    basis: KoopmanBasis
    M: Any = None            # (NL, NL) projection (Ksysid.m:1205-1217)
    K: Any = None            # the Koopman operator the model came from
    lasso: float = math.inf

    @property
    def dtype(self) -> np.dtype:
        return np.asarray(self.A).dtype


@dataclasses.dataclass(frozen=True, eq=False)
class BilinearModel:
    """z+ = A z + Beta(z) u; B is stored as (NL, m, NL)."""

    A: Any
    B: Any
    C: Any
    meta: ModelMeta
    basis: KoopmanBasis
    K: Any = None
    lasso: float = math.inf

    @property
    def dtype(self) -> np.dtype:
        return np.asarray(self.A).dtype


@dataclasses.dataclass(frozen=True, eq=False)
class NonlinearModel:
    """zeta+ = W^T g([zeta; u]), the discrete Koopman vector field; W is
    (N, nzeta) and C the (n, n) identity (``Ksysid.m:1337``)."""

    W: Any
    C: Any
    meta: ModelMeta
    basis: KoopmanBasis
    K: Any = None
    lasso: float = math.inf

    @property
    def dtype(self) -> np.dtype:
        return np.asarray(self.W).dtype


MODEL_CLASSES = {"linear": LinearModel, "bilinear": BilinearModel,
                 "nonlinear": NonlinearModel}


def from_jax_arrays(header: dict, arrays: dict):
    """(LinearModel | BilinearModel | NonlinearModel, Scaler | None) from
    the JAX package's parameters.

    ``header`` has the ``meta`` and ``basis`` entries of the JAX
    ``save_model`` header (and its ``lasso``, inf where absent);
    ``arrays`` maps names to numpy arrays: the model's own (A, B, C, or W
    and C for the nonlinear model; M and K where present), pcs (when the
    basis has one), gaussian_centers (when the header's ``has_centers``)
    and ``scaler_<field>`` entries.  Discrete and continuous models.
    """
    meta = ModelMeta(**header["meta"])
    if meta.model_type not in MODEL_CLASSES \
            or meta.time_type not in ("discrete", "continuous"):
        raise ValueError(f"unknown model {meta.model_type}/"
                         f"{meta.time_type}")
    b = header["basis"]
    centers = None
    if b.get("has_centers", False):
        centers = np.asarray(arrays["gaussian_centers"])
    basis = KoopmanBasis(
        model_type=b["model_type"], n=b["n"], m=b["m"], nd=b["nd"],
        nw=b["nw"], families=tuple(tuple(f) for f in b["families"]),
        gaussian_centers=centers,
        pcs=np.asarray(arrays["pcs"]) if "pcs" in arrays else None)
    cls = MODEL_CLASSES[meta.model_type]
    model = cls(meta=meta, basis=basis,
                lasso=float(header.get("lasso", math.inf)), **{
                    f.name: np.asarray(arrays[f.name])
                    for f in dataclasses.fields(cls) if f.name in arrays})
    fields = [f.name for f in dataclasses.fields(Scaler)]
    skw = {f: np.asarray(arrays["scaler_" + f]) for f in fields
           if "scaler_" + f in arrays}
    scaler = Scaler(**skw) if skw else None
    return model, scaler


def remix(z: torch.Tensor, w: torch.Tensor, N: int) -> torch.Tensor:
    """The loaded lifted state re-mixed with the load w (nw, B):
    kron(I_{nw+1}, z_N) [1; w] = [z_N; w1 z_N; ...] of its first N rows
    z_N (``Ksysid.val_model:1667-1671``; JAX ``models/koopman.py:231-234``),
    lanes-minor."""
    return kron_ones(w.to(z.dtype), z[:N])


def zoh_discretize(A, B, Ts: float):
    """Exact zero-order-hold discretization of z' = A z + B u through the
    augmented exponential expm([[A, B], [0, 0]] Ts) = [[Ad, Bd], [0, I]]
    (JAX ``models/koopman.py:128-144``), in f64
    (``torch.linalg.matrix_exp``) on the host: (Ad, Bd) host numpy in A's
    dtype."""
    dt = np.asarray(A).dtype
    A = torch.as_tensor(np.asarray(A, np.float64))
    B = torch.as_tensor(np.asarray(B, np.float64))
    n, m = A.shape[0], B.shape[1]
    aug = A.new_zeros((n + m, n + m))
    aug[:n, :n] = A * Ts
    aug[:n, n:] = B * Ts
    E = torch.linalg.matrix_exp(aug).numpy()
    return E[:n, :n].astype(dt), E[:n, n:].astype(dt)


def as_discrete(model):
    """The discrete-stepping equivalent of a continuous linear model (a
    discrete model as it is; JAX ``as_discrete``, :147-160).  A continuous
    bilinear or nonlinear model has no state-independent (Ad, Bd): it steps
    by ``zoh_step_bilinear`` or RK4."""
    meta = model.meta
    if meta.time_type != "continuous":
        return model
    if isinstance(model, LinearModel):
        Ad, Bd = zoh_discretize(model.A, model.B, meta.Ts)
        return dataclasses.replace(
            model, A=Ad, B=Bd,
            meta=dataclasses.replace(meta, time_type="discrete"))
    raise NotImplementedError(
        "a continuous bilinear model has no state-independent (Ad, Bd); "
        "use zoh_step_bilinear or rollout's RK4; nonlinear models "
        "integrate with RK4 only")


def zoh_step_bilinear(model, *, dtype=torch.float64, device="cuda"):
    """The exact per-Ts step of a continuous bilinear model under a held
    input (JAX ``zoh_step_bilinear``, :162-196): over one sample z' =
    (A + sum_m u_m B[:, m, :]) z is linear time-invariant, so z+ =
    expm(Ts (A + sum_m u_m B[:, m, :])) z.  Lanes-minor z (NL, B), u
    (m, B); one NL x NL ``matrix_exp`` a lane and step, for validation
    only; on the card unless ``device`` says otherwise."""
    meta = model.meta
    if meta.time_type != "continuous":
        raise ValueError("zoh_step_bilinear needs a continuous-time model")
    device = resolve_device(device)
    A = torch.as_tensor(np.asarray(model.A), dtype=dtype, device=device)
    Bm = torch.as_tensor(np.asarray(model.B), dtype=dtype, device=device)

    def step(z, u):
        gen = A[None] + torch.einsum("kmj,mb->bkj", Bm, u.to(dtype))
        E = torch.linalg.matrix_exp(meta.Ts * gen)            # (B, NL, NL)
        return torch.einsum("bkj,jb->kb", E, z)

    return step


RK4_SUBSTEPS = 8        # the JAX validation rollouts' RK4 substeps


def model_step(model, like: torch.Tensor, continuous_stepper: str = "rk4"):
    """step(z, u, w) -> z+ of any model on lanes-minor columns (z (NL, B)
    or zeta (nzeta, B) for the nonlinear model, u (m, B), w (nw, B) or
    None), in ``like``'s dtype on its device: the discrete map, or one
    sample Ts of a continuous model (linear: its ZOH discretization;
    bilinear: RK4, or ``continuous_stepper='zoh'``; nonlinear: RK4).  A
    loaded model's lifted state is re-mixed with the load first
    (``remix``), the nonlinear one lifts [zeta; u] with it."""
    meta = model.meta
    cont = meta.time_type == "continuous"
    if isinstance(model, LinearModel):
        model = as_discrete(model)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                  device=like.device)

    def held(f, z, u):
        """z+ of the vector field f(z, u): one sample of RK4 when
        continuous, else f itself."""
        if not cont:
            return f(z, u)
        return rk4(lambda zz: f(zz, u), z, meta.Ts, RK4_SUBSTEPS)

    if isinstance(model, LinearModel):
        A, B = t(model.A), t(model.B)

        def step(z, u, w):
            if w is not None:
                z = remix(z, w, meta.N)
            return A @ z + B @ u
    elif isinstance(model, BilinearModel):
        NL = np.asarray(model.A).shape[0]
        A, Bs = t(model.A), t(model.B).reshape(NL * meta.m, NL)
        f = lambda z, u: A @ z + torch.einsum(
            "kmb,mb->kb", (Bs @ z).reshape(NL, meta.m, -1), u)
        zoh = cont and continuous_stepper == "zoh"
        if zoh:
            zstep = zoh_step_bilinear(model, dtype=like.dtype,
                                      device=like.device)

        def step(z, u, w):
            if w is not None:
                z = remix(z, w, meta.N)
            return zstep(z, u) if zoh else held(f, z, u)
    elif isinstance(model, NonlinearModel):
        Wt = t(model.W).T

        def step(z, u, w):
            def F(zz, uu):
                zu = torch.cat([zz, uu])
                return Wt @ (model.basis.lift(zu) if w is None
                             else model.basis.lift_loaded(zu, w))
            return held(F, z, u)
    else:
        raise TypeError(f"unknown model type {type(model)}")
    return step


def rollout(model, init: torch.Tensor, U: torch.Tensor,
            W: torch.Tensor = None, continuous_stepper: str = "rk4"):
    """Open-loop rollout of a model (JAX ``models/koopman.py:208-314``):
    from ``init`` -- the lifted state (NL,), or zeta (nzeta,) for the
    nonlinear model -- over the inputs U (T, m), in init's dtype on its
    device, each step ``model_step``'s (a continuous model over one sample
    Ts).  A loaded model (nw > 0) takes the scaled loads W (T, nw): each
    step re-mixes the lifted state with the step's load (``remix``), and
    the nonlinear model lifts [zeta; u] with it.  Returns (Y [T, n],
    Z [T, NL]): Y = Z C^T, or zeta's first n entries for the nonlinear
    model."""
    meta = model.meta
    if (W is None) != (meta.nw == 0):
        raise ValueError("a loaded model's rollout takes the loads W, an "
                         "unloaded one none")
    like = dict(dtype=init.dtype, device=init.device)
    U = U.to(**like)
    W = None if W is None else W.to(**like)
    step = model_step(model, init, continuous_stepper)
    NL = init.shape[0]
    Z = init.new_empty((U.shape[0], NL))
    Z[0] = init
    z = init[:, None]
    for k in range(U.shape[0] - 1):
        z = step(z, U[k][:, None], None if W is None else W[k][:, None])
        Z[k + 1] = z[:, 0]
    if isinstance(model, NonlinearModel):
        return Z[:, :meta.n], Z
    return Z @ torch.as_tensor(np.asarray(model.C), **like).T, Z
