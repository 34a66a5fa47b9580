"""Poly observable dictionaries (port of the JAX package's
``ops/observables.py``: the poly tables :42-101, ``KoopmanBasis`` with its
full, econ and bilinear lifts, ``build_basis`` and ``delay_embed``
:260-346).

Basis layout (reference-exact): the full basis is
g = [zeta ; monomials of degree 2..d ; 1] with monomial rows in
``partitions.m`` order, the econ basis [zeta ; pcs^T g(zeta) ; 1], the
bilinear lift [g ; u1*g ; ... ; um*g], the loaded lift
[g ; w1*g ; ... ; w_nw*g] and both at once.  The lifts here are
lanes-minor:
zeta is (nz, B), features are (rows, B).  Only the poly family is ported;
the others (fourier, fourier_sparser, gaussian, hermite) raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["partitions_ones", "poly_exponents", "poly_parent_tables",
           "poly_features", "KoopmanBasis", "kron_ones", "build_basis",
           "delay_embed"]


def _require_poly(kind: str):
    if kind != "poly":
        raise NotImplementedError(
            f"observable family {kind!r} is not ported; only 'poly' is "
            f"(ROADMAP.md queue 1, item 2)")


def partitions_ones(total: int, n: int) -> np.ndarray:
    """All non-negative integer vectors of length ``n`` summing to
    ``total``, in ``partitions.m`` order (recurse over the count of the
    LAST element)."""
    if n == 1:
        return np.array([[total]], dtype=np.int32)
    rows = []
    for i in range(total + 1):
        sub = partitions_ones(total - i, n - 1)
        rows.append(np.concatenate(
            [sub, np.full((sub.shape[0], 1), i, np.int32)], axis=1))
    return np.concatenate(rows, axis=0)


def poly_exponents(nzeta: int, degree: int) -> np.ndarray:
    """Exponent rows of all monomials of total degree 1..degree."""
    return np.concatenate([partitions_ones(d, nzeta)
                           for d in range(1, degree + 1)], axis=0)


def poly_parent_tables(nz: int, degree: int):
    """Parent-recurrence gather tables of the degree-blocked poly lift.

    Every degree-d monomial is z_i times a unique degree-(d-1) parent (its
    lowest nonzero exponent dimension).  Returns (blocks, tables): the
    exponent blocks of degrees 1..degree and, for degrees 2..degree,
    (parent_idx, dim_idx) int32 arrays indexing the previous block / z.
    """
    blocks = [partitions_ones(d, nz) for d in range(1, degree + 1)]
    tables = []
    pos = {tuple(int(v) for v in e): r for r, e in enumerate(blocks[0])}
    for d in range(2, degree + 1):
        parent_idx = np.empty(len(blocks[d - 1]), np.int32)
        dim_idx = np.empty(len(blocks[d - 1]), np.int32)
        newpos = {}
        for r, row in enumerate(blocks[d - 1]):
            e = tuple(int(v) for v in row)
            i = next(k for k in range(nz) if e[k] > 0)
            parent = e[:i] + (e[i] - 1,) + e[i + 1:]
            parent_idx[r] = pos[parent]
            dim_idx[r] = i
            newpos[e] = r
        tables.append((parent_idx, dim_idx))
        pos = newpos
    return blocks, tables


def poly_features(zeta: torch.Tensor, tables) -> torch.Tensor:
    """Monomials of degree 2.. of lanes-minor ``zeta`` (nz, B), one gather
    and one multiply per degree block: (n_mono, B)."""
    idx = lambda a: torch.as_tensor(a, dtype=torch.long, device=zeta.device)
    feats, prev = [], zeta
    for parent_idx, dim_idx in tables:
        prev = prev[idx(parent_idx)] * zeta[idx(dim_idx)]
        feats.append(prev)
    if not feats:
        return zeta.new_zeros((0,) + tuple(zeta.shape[1:]))
    return torch.cat(feats, dim=0)


@dataclasses.dataclass(frozen=True, eq=False)
class KoopmanBasis:
    """A poly observable dictionary, optionally with a PCA econ basis.

    n, m, nd : state/input dims and delay count
    nzeta    : n*(nd+1) + m*nd            (``Ksysid.m:86``)
    nzeta_aug: nzeta (+ m for 'nonlinear' models, whose lift takes
               [zeta; u], ``Ksysid.m:475-477``)
    N        : dimension of the working (econ) basis (``params.N``)
    N_full   : dimension of the full (pre-PCA) basis
    pcs      : optional (N_full, npcs) PCA components, host numpy
    """

    model_type: str
    n: int
    m: int
    nd: int
    nw: int
    families: Tuple[Tuple[str, int], ...]
    pcs: Optional[np.ndarray] = None          # (N_full, npcs)
    # device copies of the index tables and pcs^T, by (device, dtype)
    _on_device: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False)

    @property
    def nzeta(self) -> int:
        return self.n * (self.nd + 1) + self.m * self.nd

    @property
    def nzeta_aug(self) -> int:
        return self.nzeta + (self.m if self.model_type == "nonlinear" else 0)

    @property
    def N_full(self) -> int:
        """Full basis length: zeta, each family's monomials of degree 2..d
        (its first nz rows repeat zeta) and the trailing constant."""
        nz = self.nzeta_aug
        for kind, _ in self.families:
            _require_poly(kind)
        return nz + sum(math.comb(nz + d, d) - 1 - nz
                        for _, d in self.families) + 1

    @property
    def N(self) -> int:
        """Dimension of the working (econ) basis."""
        if self.pcs is None:
            return self.N_full
        return self.nzeta_aug + self.pcs.shape[1] + 1

    @property
    def N_loaded(self) -> int:
        return self.N * (self.nw + 1)

    def _device_tables(self, device: torch.device):
        """Each family's (parent, dim) index tables on ``device``."""
        key = ("tables", device)
        if key not in self._on_device:
            out = []
            for kind, degree in self.families:
                _require_poly(kind)
                out.append(tuple(
                    (torch.as_tensor(pi, dtype=torch.long, device=device),
                     torch.as_tensor(di, dtype=torch.long, device=device))
                    for pi, di in poly_parent_tables(self.nzeta_aug,
                                                     degree)[1]))
            self._on_device[key] = out
        return self._on_device[key]

    def _pcs_t(self, dtype: torch.dtype, device: torch.device):
        key = ("pcs_t", dtype, device)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(
                np.ascontiguousarray(self.pcs.T), dtype=dtype, device=device)
        return self._on_device[key]

    def lift_full(self, zeta: torch.Tensor) -> torch.Tensor:
        """Full basis g of lanes-minor zeta_aug (nz, B): (N_full, B)
        (``Ksysid.m:484-533``)."""
        if zeta.shape[0] != self.nzeta_aug:
            raise ValueError(f"lift expects zeta of {self.nzeta_aug} rows, "
                             f"got {tuple(zeta.shape)}")
        parts = [zeta] + [poly_features(zeta, t)
                          for t in self._device_tables(zeta.device)]
        parts.append(zeta.new_ones((1,) + tuple(zeta.shape[1:])))
        return torch.cat(parts)

    def lift(self, zeta: torch.Tensor) -> torch.Tensor:
        """Working (econ) basis of lanes-minor zeta (nz, B): (N, B)
        (``Ksysid.econ_full:1614-1618``)."""
        g = self.lift_full(zeta)
        if self.pcs is None:
            return g
        P_T = self._pcs_t(zeta.dtype, zeta.device)
        ones = zeta.new_ones((1,) + tuple(zeta.shape[1:]))
        return torch.cat([zeta, P_T @ g, ones])

    def lift_input(self, zeta: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Bilinear lift [g ; u1*g ; ...] of lanes-minor zeta (nz, B) and
        u (m, B): (N*(m+1), B) (``Ksysid.m:508-516``)."""
        g = self.lift(zeta)
        return kron_ones(u.to(g.dtype), g)

    def lift_loaded(self, zeta: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Loaded lift [g ; w1*g ; ...] of lanes-minor zeta (nz, B) and
        the scaled load w (nw, B): (N*(nw+1), B) (``Ksysid.m:595-599``)."""
        g = self.lift(zeta)
        return kron_ones(w.to(g.dtype), g)

    def lift_loaded_input(self, zeta: torch.Tensor, w: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
        """Bilinear and loaded lift [gl ; u1*gl ; ...] with gl the loaded
        lift: (N*(nw+1)*(m+1), B) (``Ksysid.m:601-610``)."""
        gl = self.lift_loaded(zeta, w)
        return kron_ones(u.to(gl.dtype), gl)

    def with_pcs(self, pcs: np.ndarray) -> "KoopmanBasis":
        return dataclasses.replace(self, pcs=np.asarray(pcs))


def kron_ones(c: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """kron([1; c], g) over the rows, lanes-minor: c (k, B), g (N, B) ->
    ((k+1)*N, B), the blocks [g; c_1 g; ...] (the first block g itself)."""
    one_c = torch.cat([g.new_ones((1,) + tuple(g.shape[1:])), c])
    return (one_c[:, None] * g[None]).reshape((-1,) + tuple(g.shape[1:]))


def build_basis(cfg, n: int, m: int, nw: int = 0) -> KoopmanBasis:
    """The observable dictionary of a ``SysidConfig`` (poly families
    only)."""
    families = tuple(zip(cfg.obs_type, cfg.obs_degree))
    for kind, _ in families:
        _require_poly(kind)
    return KoopmanBasis(model_type=cfg.model_type, n=n, m=m, nd=cfg.delays,
                        nw=nw if cfg.loaded else 0, families=families)


def delay_embed(y: np.ndarray, u: np.ndarray, nd: int):
    """zeta_k = [y_k, y_{k-1..k-nd}, u_{k-1..k-nd}] rows
    (``Ksysid.get_zeta:868-907``): (zeta [T-nd, nzeta], uzeta [T-nd, m]),
    row i at original time index i+nd.  Host numpy."""
    y = np.asarray(y)
    u = np.asarray(u)
    if nd == 0:
        return y.copy(), u.copy()
    rows = []
    for i in range(nd, y.shape[0]):
        ydel = [y[i - j] for j in range(1, nd + 1)]
        udel = [u[i - j] for j in range(1, nd + 1)]
        rows.append(np.concatenate([y[i]] + ydel + udel))
    return np.stack(rows), u[nd:].copy()
