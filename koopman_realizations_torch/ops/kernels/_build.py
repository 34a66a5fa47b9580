"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into a shared library with a plain C interface (no
PyTorch headers: a build takes seconds, not minutes), loaded with ctypes.
Never ``--use_fast_math``: divides and square roots stay IEEE
(``-prec-div=true -prec-sqrt=true``) and ``sinf``/``cosf`` precise.

A kernel is specialized to one configuration: its dimensions, the poly
lift's monomial recurrence and the plant constants go into a generated
header, which a generated translation unit includes before the source.
Libraries land in ``koopman_realizations_torch/build/`` under a name
hashed from the sources, the configuration and the flags, so a changed
source or configuration builds anew and an unchanged one loads at once.
The build runs on first use; ``build_all`` starts one nvcc per kernel at
once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-prec-div=true",
              "-prec-sqrt=true", "-Xptxas", "-v")


@dataclass(frozen=True)
class KernelSpec:
    """One kernel build: ``source`` in csrc/ plus its configuration
    header text (``#define`` lines)."""

    source: str
    config: str


@dataclass
class BuildResult:
    lib: ctypes.CDLL
    path: Path
    seconds: float
    cached: bool
    ptxas: list = field(default_factory=list)   # `ptxas -v` + spill lines


_BY_SPEC: dict = {}     # KernelSpec -> loaded CDLL


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the card")


def _digest(spec: KernelSpec) -> str:
    h = hashlib.sha256()
    h.update(spec.config.encode())
    h.update(spec.source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _paths(spec: KernelSpec):
    stem = f"{Path(spec.source).stem}-{_digest(spec)}"
    return BUILD / f"{stem}.so", BUILD / f"{stem}.cu", BUILD / f"{stem}.log"


class _Pending:
    def __init__(self, spec: KernelSpec):
        self.spec = spec
        self.so, self.tu, self.logp = _paths(spec)
        self.t0 = time.perf_counter()
        self.proc = None
        self.tmp = None
        if self.so.is_file():
            return
        BUILD.mkdir(parents=True, exist_ok=True)
        self.tu.write_text(
            "// generated: configuration of one kernel build\n"
            + spec.config + f'\n#include "{spec.source}"\n')
        self.tmp = self.so.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
               str(self.tmp), str(self.tu)]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(self) -> BuildResult:
        cached = self.proc is None
        if not cached:
            log, _ = self.proc.communicate()
            self.logp.write_text(log)
            if self.proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {self.spec.source} "
                    f"(rc {self.proc.returncode}):\n{log}")
            os.replace(self.tmp, self.so)
        log = self.logp.read_text() if self.logp.is_file() else ""
        lib = _BY_SPEC.get(self.spec)
        if lib is None:
            lib = _BY_SPEC[self.spec] = ctypes.CDLL(str(self.so))
        return BuildResult(
            lib=lib, path=self.so, seconds=time.perf_counter() - self.t0,
            cached=cached,
            ptxas=[ln for ln in log.splitlines()
                   if "ptxas" in ln or "spill" in ln])


def build_all(specs) -> list:
    """Build (or load) every spec, all nvcc processes running at once;
    if one fails, the others are stopped before the error propagates."""
    pending = []
    try:
        for s in specs:
            pending.append(_Pending(s))
        return [p.finish() for p in pending]
    finally:
        for p in pending:
            if p.proc is not None and p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait()


def load(spec: KernelSpec) -> ctypes.CDLL:
    """The loaded library of one spec, built on first use."""
    lib = _BY_SPEC.get(spec)
    return lib if lib is not None else build_all([spec])[0].lib


def hexf(v) -> str:
    """Exact C++ literal of v rounded to f32 (hex float)."""
    return float(np.float32(v)).hex() + "f"


def c_array(values, fmt=hexf) -> str:
    """C initializer list (nested for 2-D) of f32 or int values."""
    a = np.asarray(values)
    if a.ndim == 1:
        return "{" + ", ".join(fmt(v) for v in a) + "}"
    return "{" + ", ".join(c_array(r, fmt) for r in a) + "}"
