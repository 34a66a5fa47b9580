"""Observable dictionaries (port of the JAX package's
``ops/observables.py``: the poly tables :42-101, the Hermite table
:103-120, ``KoopmanBasis`` with its five families (poly, fourier,
fourier_sparser, gaussian, hermite, :163-259) and its full, econ, bilinear
and loaded lifts, ``build_basis`` with the seeded gaussian centers,
``delay_embed`` and ``zeta_from_window`` :260-361).

Basis layout (reference-exact): the full basis is
g = [zeta ; monomials of degree 2..d ; 1] with monomial rows in
``partitions.m`` order, the econ basis [zeta ; pcs^T g(zeta) ; 1], the
bilinear lift [g ; u1*g ; ... ; um*g], the loaded lift
[g ; w1*g ; ... ; w_nw*g] and both at once.  The lifts here are
lanes-minor:
zeta is (nz, B), features are (rows, B), in zeta's dtype on its device.
A basis is a list of families whose features follow zeta in order:
poly (monomials of degree 2..d by the parent recurrence), fourier (the
full tensor product of [1, cos(2 pi j z_i), sin(2 pi j z_i)]_j over the
coordinates, its constant dropped), fourier_sparser (products of
sin(2 pi M z) and cos(2 pi M z) over the multiplier rows of degree 1..d),
gaussian (exp(-|z - c_j|^2) at seeded centers c_j in [-1, 1]) and hermite
(products of physicists' Hermite polynomials over the exponent rows of
degree 1..d).  Each family's device operands (index tables, frequency
rows, centers) come from ``family_operands``; ``lift_full_with`` lifts
with them, so a controller can keep them as buffers of its module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["partitions_ones", "poly_exponents", "poly_parent_tables",
           "poly_features", "hermite_table", "family_count",
           "family_operands", "family_features", "lift_full_with",
           "KoopmanBasis", "kron_ones", "build_basis", "delay_embed",
           "zeta_from_window"]

FAMILIES = ("poly", "fourier", "fourier_sparser", "gaussian", "hermite")


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


def _count_poly(nz: int, degree: int) -> int:
    """Monomials of total degree 1..degree in nz variables."""
    return math.comb(nz + degree, degree) - 1


def _partition_rows(nz: int, degree: int) -> np.ndarray:
    """The exponent (or multiplier) rows of degree 1..degree, in
    ``partitions.m`` order."""
    return np.concatenate([partitions_ones(d, nz)
                           for d in range(1, degree + 1)], axis=0)


def hermite_table(max_order: int, z: torch.Tensor) -> torch.Tensor:
    """Physicists' Hermite polynomials H_0..H_max of z elementwise
    (H_0 = 1, H_1 = 2z, H_{k+1} = 2 z H_k - 2 k H_{k-1}; JAX
    ``_hermite_table``, ``Ksysid.get_hermite:820-831``):
    (max_order+1,) + z.shape."""
    rows = [torch.ones_like(z)]
    if max_order >= 1:
        rows.append(2.0 * z)
    for k in range(1, max_order):
        rows.append(2.0 * z * rows[k] - 2.0 * k * rows[k - 1])
    return torch.stack(rows)


def family_count(kind: str, degree: int, nz: int) -> int:
    """Feature rows of one family over nz coordinates (JAX
    ``KoopmanBasis._family_count``)."""
    if kind == "poly":
        return _count_poly(nz, degree) - nz     # its first nz rows repeat z
    if kind == "fourier":
        return (1 + 2 * degree) ** nz - 1
    if kind == "fourier_sparser":
        return _count_poly(2 * nz, degree)
    if kind == "gaussian":
        return degree
    if kind == "hermite":
        return _count_poly(nz, degree)
    raise ValueError(f"unknown observable family {kind!r}")


def family_operands(kind: str, degree: int, nz: int, centers, *,
                    dtype: torch.dtype, device) -> dict:
    """One family's device operands, by name: poly the parent-recurrence
    index tables (``par<d>``, ``dim<d>``); fourier the frequencies 2 pi j
    (``freq``); fourier_sparser each row's nonzero multipliers M (at most
    ``degree``): their coordinates (``coord``), 2 pi M (``w``), whether
    each is of the sin half (``sin``) and which are not padding
    (``valid``), all (rows, degree); gaussian the centers (``c``,
    (nz, k)); hermite the exponent rows (``O``, (rows, nz)).  Frequencies are formed in f64 on the host,
    then cast."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                    device=device)
    if kind == "poly":
        ops = {}
        for d, (pi, di) in enumerate(poly_parent_tables(nz, degree)[1]):
            ops[f"par{d}"], ops[f"dim{d}"] = idx(pi), idx(di)
        return ops
    if kind == "fourier":
        return {"freq": t(2 * np.pi * np.arange(1, degree + 1))}
    if kind == "fourier_sparser":
        # each row's nonzero multipliers, sin half first, in coordinate
        # order, padded to the row length `degree` (a padded factor is 1)
        M = _partition_rows(2 * nz, degree)
        rows = M.shape[0]
        pos = np.zeros((rows, degree), np.int64)
        w = np.zeros((rows, degree))
        valid = np.zeros((rows, degree), bool)
        for r in range(rows):
            nzs = np.nonzero(M[r])[0]
            pos[r, :len(nzs)], w[r, :len(nzs)] = nzs, M[r, nzs]
            valid[r, :len(nzs)] = True
        return {"coord": idx(pos % nz), "w": t(2 * np.pi * w),
                "sin": torch.as_tensor(pos < nz, device=device),
                "valid": torch.as_tensor(valid, device=device)}
    if kind == "gaussian":
        if centers is None:
            raise ValueError("a gaussian family needs the basis's centers")
        return {"c": t(centers)}
    if kind == "hermite":
        return {"O": idx(_partition_rows(nz, degree))}
    raise ValueError(f"unknown observable family {kind!r}")


def family_features(kind: str, degree: int, zeta: torch.Tensor,
                    ops: dict) -> torch.Tensor:
    """One family's features of lanes-minor zeta (nz, B) with its
    ``family_operands``: (rows, B) (JAX ``_family_feats``, vector by
    vector there)."""
    nz, lanes = zeta.shape[0], tuple(zeta.shape[1:])
    if kind == "poly":
        tables = [(ops[f"par{d}"], ops[f"dim{d}"])
                  for d in range(degree - 1)]
        return poly_features(zeta, tables)
    if kind == "fourier":
        # per coordinate [1, cos(w_1 z_i), sin(w_1 z_i), ...]; the tensor
        # product runs the last coordinate fastest, its constant dropped
        ang = ops["freq"][:, None, None] * zeta[None]       # (d, nz, B)
        cs = torch.stack([torch.cos(ang), torch.sin(ang)], 1) \
            .reshape((2 * degree, nz) + lanes)
        cols = torch.cat([zeta.new_ones((1, nz) + lanes), cs])
        feats = cols[:, 0]
        for i in range(1, nz):
            feats = (feats[:, None] * cols[None, :, i]) \
                .reshape((-1,) + lanes)
        return feats[1:]
    if kind == "fourier_sparser":
        # prod over the row's nonzero multipliers M of sin(2 pi M z_i)
        # (its sin half) and cos(2 pi M z_i) (its cos half): the JAX
        # product over all 2 nz entries, the ones left out
        ang = ops["w"][..., None] * zeta[ops["coord"]]      # (rows, d, B)
        f = torch.where(ops["sin"][..., None], torch.sin(ang),
                        torch.cos(ang))
        f = torch.where(ops["valid"][..., None], f, zeta.new_ones(()))
        return torch.prod(f, dim=1)
    if kind == "gaussian":
        r2 = ((zeta[:, None] - ops["c"][..., None]) ** 2).sum(0)
        return torch.exp(-r2)
    if kind == "hermite":
        H = hermite_table(degree, zeta)                     # (d+1, nz, B)
        O = ops["O"]
        ar = torch.arange(nz, device=zeta.device)
        return torch.prod(H[O, ar[None, :]], dim=1)
    raise ValueError(f"unknown observable family {kind!r}")


def lift_full_with(families, ops, zeta: torch.Tensor) -> torch.Tensor:
    """The full basis [zeta; each family's features; 1] of lanes-minor
    zeta (nz, B) with the families' operands ``ops`` (one dict each)."""
    parts = [zeta] + [family_features(k, d, zeta, o)
                      for (k, d), o in zip(families, ops)]
    parts.append(zeta.new_ones((1,) + tuple(zeta.shape[1:])))
    return torch.cat(parts)


def econ_with(pcs_t, zeta: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The econ basis [zeta; pcs^T g; 1] of the full basis g (``pcs_t``
    None: g itself)."""
    if pcs_t is None:
        return g
    ones = zeta.new_ones((1,) + tuple(zeta.shape[1:]))
    return torch.cat([zeta, pcs_t @ g, ones])


@dataclasses.dataclass(frozen=True, eq=False)
class KoopmanBasis:
    """An observable dictionary, optionally with a PCA econ basis.

    n, m, nd : state/input dims and delay count
    nzeta    : n*(nd+1) + m*nd            (``Ksysid.m:86``)
    nzeta_aug: nzeta (+ m for 'nonlinear' models, whose lift takes
               [zeta; u], ``Ksysid.m:475-477``)
    N        : dimension of the working (econ) basis (``params.N``)
    N_full   : dimension of the full (pre-PCA) basis
    families : ((kind, degree), ...) in ``obs_type`` order
    gaussian_centers: (nzeta_aug, k) centers of the gaussian family
    pcs      : optional (N_full, npcs) PCA components, host numpy
    """

    model_type: str
    n: int
    m: int
    nd: int
    nw: int
    families: Tuple[Tuple[str, int], ...]
    gaussian_centers: Optional[np.ndarray] = None   # (nzeta_aug, degree)
    pcs: Optional[np.ndarray] = None                # (N_full, npcs)
    # device operands of the families and pcs^T, by (device, dtype)
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
        """Full basis length: zeta, each family's features and the
        trailing constant."""
        nz = self.nzeta_aug
        return nz + sum(family_count(k, d, nz) for k, d in self.families) + 1

    @property
    def N(self) -> int:
        """Dimension of the working (econ) basis."""
        if self.pcs is None:
            return self.N_full
        return self.nzeta_aug + self.pcs.shape[1] + 1

    @property
    def N_loaded(self) -> int:
        return self.N * (self.nw + 1)

    @property
    def single_poly(self) -> bool:
        """One poly family: the dictionary of the analytic Jacobian and
        of the lift-fused kernels."""
        return len(self.families) == 1 and self.families[0][0] == "poly"

    def operands(self, dtype: torch.dtype, device) -> list:
        """Each family's ``family_operands`` on ``device`` in ``dtype``."""
        return [family_operands(k, d, self.nzeta_aug, self.gaussian_centers,
                                dtype=dtype, device=device)
                for k, d in self.families]

    def _device_ops(self, dtype: torch.dtype, device: torch.device):
        key = ("ops", dtype, device)
        if key not in self._on_device:
            self._on_device[key] = self.operands(dtype, device)
        return self._on_device[key]

    def _pcs_t(self, dtype: torch.dtype, device: torch.device):
        if self.pcs is None:
            return None
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
        return lift_full_with(self.families,
                              self._device_ops(zeta.dtype, zeta.device), zeta)

    def lift(self, zeta: torch.Tensor) -> torch.Tensor:
        """Working (econ) basis of lanes-minor zeta (nz, B): (N, B)
        (``Ksysid.econ_full:1614-1618``)."""
        return econ_with(self._pcs_t(zeta.dtype, zeta.device), zeta,
                         self.lift_full(zeta))

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
    """The observable dictionary of a ``SysidConfig``.  A gaussian family
    takes centers uniform in [-1, 1] (``Ksysid.m:803``) drawn by numpy's
    Generator seeded with ``cfg.seed``, the JAX package's call
    (``build_basis``, observables.py:317-321), so both packages draw the
    same centers bit for bit."""
    families = tuple(zip(cfg.obs_type, cfg.obs_degree))
    for kind, _ in families:
        if kind not in FAMILIES:
            raise ValueError(f"unknown observable family {kind!r}")
    basis = KoopmanBasis(model_type=cfg.model_type, n=n, m=m, nd=cfg.delays,
                         nw=nw if cfg.loaded else 0, families=families)
    if any(k == "gaussian" for k, _ in families):
        rng = np.random.default_rng(cfg.seed)
        deg = max(d for k, d in families if k == "gaussian")
        centers = 2.0 * rng.random((basis.nzeta_aug, deg)) - 1.0
        basis = dataclasses.replace(basis, gaussian_centers=centers)
    return basis


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


def zeta_from_window(ywin: torch.Tensor, uwin: torch.Tensor,
                     nd: int) -> torch.Tensor:
    """zeta of the newest step from trailing windows, lanes-minor: ywin
    (nd+1, n, B) and uwin (nd+1, m, B), rows oldest..newest -> (nzeta, B),
    the newest output first, then the output delays, then the input delays
    uwin[-2] .. uwin[-1-nd] (JAX ``zeta_from_window``, observables.py:
    347-361; ``Kmpc.get_mpcInput``'s ``get_zeta`` layout)."""
    parts = [ywin[-1]] + [ywin[-1 - j] for j in range(1, nd + 1)] \
        + [uwin[-1 - j] for j in range(1, nd + 1)]
    return torch.cat(parts)
