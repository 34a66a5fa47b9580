"""Koopman model containers of the port (``models/koopman.py`` of the JAX
package): the linear realization z+ = A z + B u and the bilinear one
z+ = A z + Beta(z) u with Beta(z) = einsum('kmj,j->km', B, z), both with
y = C z, and the nonlinear one zeta+ = W^T g([zeta; u]); and their
open-loop rollouts (``rollout``, discrete models, with loads or without).

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
    basis has one) and ``scaler_<field>`` entries.
    """
    meta = ModelMeta(**header["meta"])
    if meta.model_type not in MODEL_CLASSES or meta.time_type != "discrete":
        raise NotImplementedError(
            f"only discrete linear, bilinear and nonlinear models are "
            f"ported (got {meta.model_type}/{meta.time_type})")
    b = header["basis"]
    basis = KoopmanBasis(
        model_type=b["model_type"], n=b["n"], m=b["m"], nd=b["nd"],
        nw=b["nw"], families=tuple(tuple(f) for f in b["families"]),
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


def rollout(model, init: torch.Tensor, U: torch.Tensor,
            W: torch.Tensor = None):
    """Open-loop rollout of a discrete model (JAX
    ``models/koopman.py:208-314``): from ``init`` -- the lifted state
    (NL,), or zeta (nzeta,) for the nonlinear model -- over the inputs U
    (T, m), in init's dtype on its device.  A loaded model (nw > 0) takes
    the scaled loads W (T, nw): each step re-mixes the lifted state with
    the step's load (``remix``), and the nonlinear model lifts
    [zeta; u] with it.  Returns (Y [T, n], Z [T, NL]): Y = Z C^T, or
    zeta's first n entries for the nonlinear model."""
    meta = model.meta
    if meta.time_type != "discrete":
        raise NotImplementedError(
            "rollout is ported for discrete models (ROADMAP.md queue 1, "
            "item 2)")
    if (W is None) != (meta.nw == 0):
        raise ValueError("a loaded model's rollout takes the loads W, an "
                         "unloaded one none")
    like = dict(dtype=init.dtype, device=init.device)

    def t(a):
        return torch.as_tensor(np.asarray(a), **like)
    U = U.to(**like)
    W = None if W is None else W.to(**like)
    NL = init.shape[0]
    if isinstance(model, LinearModel):
        A, B = t(model.A), t(model.B)

        def step(z, u, w):
            if w is not None:
                z = remix(z, w, meta.N)
            return A @ z + B @ u
    elif isinstance(model, BilinearModel):
        A, Bs = t(model.A), t(model.B).reshape(NL * meta.m, NL)

        def step(z, u, w):
            if w is not None:
                z = remix(z, w, meta.N)
            return A @ z + (Bs @ z).reshape(NL, meta.m) @ u
    elif isinstance(model, NonlinearModel):
        Wt = t(model.W).T

        def step(z, u, w):
            zu = torch.cat([z, u])
            return Wt @ (model.basis.lift(zu) if w is None
                         else model.basis.lift_loaded(zu, w))
    else:
        raise TypeError(f"unknown model type {type(model)}")
    Z = init.new_empty((U.shape[0], NL))
    Z[0] = init
    z = init[:, None]
    for k in range(U.shape[0] - 1):
        z = step(z, U[k][:, None], None if W is None else W[k][:, None])
        Z[k + 1] = z[:, 0]
    if isinstance(model, NonlinearModel):
        return Z[:, :meta.n], Z
    return Z @ t(model.C).T, Z
