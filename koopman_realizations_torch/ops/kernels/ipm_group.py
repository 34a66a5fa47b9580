"""Launch plan of the cooperative interior point (``csrc/ipm_group.cuh``).

A group of ``group`` threads solves one lane's QP (the kernels
``ipm_factored.cu``, ``nmpc_multipass.cu``, ``nmpc_stage.cu``,
``nmpc_pass.cu``, ``step_fused.cu``, ``linear_step_fused.cu``,
``bilin_lift.cu`` and ``ipm_shared.cu``): the
lane's scaled Hessian, its Newton matrix and
factor live in shared memory, its constraint rows are spread over the
group's threads (row c on thread c % group), its n-vectors over their
owners (entry i on thread i % group).
The lane-shared operands (the equilibrated rows A, the A^T D A tables and
A's nonzero structure) are loaded into shared memory once per block.
This module is pure Python: it picks the group size from the QP's
dimensions, lays out the block's dynamic shared memory and writes the
``#define`` lines of one build, so the CPU tests can check every
build's plan and the kernels read their offsets from one place.

Layout of a block's dynamic shared memory, in floats (4-byte words):

- ``A``  (mc, AS): the rows, padded to an odd stride AS so that a group
  reading one column over its rows hits distinct banks;
- ``Wd`` banded (n, WS) and ``Wo`` (n - band, WS) with WS odd, or dense
  the rows' nonzero values (mc, rnz);
- ``sp``: A's nonzero structure as byte lists, each row's columns and
  each column's rows in ascending order with their counts (built by the
  block from A, so the products with A and the banded A^T D A skip the
  structural zeros);
- ``ring`` (p row slots, filled in two halves): a W row and a v entry
  for every lane of the block, [lane][i] with an odd lane stride NP
  (``ipm_factored`` only), over the lane and work regions, which are
  staged only after the Gram has read it;
- ``lane`` (lanes per block): [x: n][obj: 1][rest], rest holding the
  scaled Hessian (packed, T), q (n) and u_prev (m) while the lane is
  solved, and s, lam (2 mc) after its last solve (``ipm_factored``);
- ``work`` (groups per block): [M: T][dx: n][vec: mc], the Newton matrix
  and its factor, the broadcast direction and the row vector a group
  transposes through (compact: then the lane's Hessian, T, unless the
  Hessian is lane-shared: ``PSH``, one packed copy a block before the
  lane regions, the linear step's).

The compact plan of the NMPC kernels (``csrc/nmpc_group.cuh``:
``nmpc_multipass``, ``nmpc_stage``, ``nmpc_pass``) takes a lane a thread
for the stage sweep, so lanes per block = threads, solved a round of
threads // group lanes at a time.  Its lane region is [x: n][obj: 1]
[u_prev: m] only -- x the primal start (multipass: the previous pass's
x; the one-pass kernels: the shipped x0, written by the lane's thread)
and the solve's iterate, obj the lane's objective scale (the warm dual
start reads it) -- with an odd stride; the scaled Hessian (packed, T)
and q go from the lane's thread to its group through a row of device
scratch (``scratch_floats`` a lane, row b for the lane's place b in the
grid).  ``nmpc_multipass`` sweeps and solves in one launch, pass after
pass, the rows written and read back within it; the one-pass kernels run
their sweep as a launch of its own (a thread a lane, no cap on its
registers) that writes the scratch rows and obj, and the group solve
follows on the stream (``csrc/lane_group.cuh``).

The fused steps (``csrc/step_group.cuh``) take the same compact plan
with a front launch a thread a lane: the scratch row holds what the
front hands over (``scratch``: ``step_fused`` the Hessian, q, obj;
``linear_step_fused`` nothing more, its Hessian lane-shared and its
gradient formed by the groups) and the plant's new state, marker
outputs and finite flag (``plant`` floats), and the lane region one
more float, the freeze decision the group passes to the lane's thread.

``bilin_lift`` takes the bilinear step's plan without the plant: its
front hands the Hessian, q and obj over, its groups store s and lam.
``ipm_shared`` has no front (q, b and x0 come from the caller; the
groups read them lanes-minor): its lane-shared build keeps the Hessian
one copy a block (``PSH``), as the linear step; its per-lane build
(``lane_p``) stages each round's lanes' P, both triangles, into the
groups' work regions ([M][dx][vec][Pr: T][Pu: T]) and keeps iobj in the
lane region after obj (``m`` = 1).  Either may take one round of
``threads // group`` lanes a block (``lanes`` = groups): the threads
past the block's lanes only help load its shared operands.

Per-lane and per-group strides are padded to ``pad``: a multiple of 32
plus the group size, so that the groups of one warp (group < 32) read
their own regions on disjoint banks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from koopman_realizations_torch.ops.kernels import _build
from koopman_realizations_torch.ops.qp import Constraints

# the shared memory one block may use on an H100 (sm_90)
SMEM_LIMIT = 232448
# group size by the interior point's width: a warp a lane from n=20 on;
# the narrow (n=12) builds take the size measured fastest (PERF.md §6)
WIDE_N = 20
NARROW_GROUP = 16
# threads per block of ipm_factored (lanes per block = THREADS // group)
# and, by width, the blocks an SM its launch bounds ask for (measured
# fastest; a warp a lane at n=27 is then held to 85 registers)
FACTORED_THREADS = 256
WIDE_MIN_BLOCKS = 3
# nmpc_multipass: one lane a thread in the stage sweep, so lanes per
# block = threads, solved a round of threads // group lanes at a time;
# its group size and blocks an SM as measured fastest (PERF.md §6)
NMPC_THREADS = 128
NMPC_GROUP = 8
NMPC_MIN_BLOCKS = 4
# the wide NMPC builds (the unblocked stack, n=27): the sweep hands each
# pass's projected rows over, a warp a lane forms the Gram and solves;
# two blocks an SM fill its shared memory, so no bound on the registers
NMPC_WIDE_GROUP = 32
NMPC_WIDE_MIN_BLOCKS = 0
# nmpc_stage (each trajectory mode) and nmpc_pass, one pass a launch:
# the compact plan (the sweep a launch of its own), its group size and
# the solve's blocks an SM as measured fastest (PERF.md §6)
ONEPASS_GROUP = 4
ONEPASS_MIN_BLOCKS = 4
# step_fused and linear_step_fused: the compact plan (the front a launch
# of its own), its group size and the solve's blocks an SM as measured
# fastest (PERF.md §6)
STEP_GROUP = 4
STEP_MIN_BLOCKS = 4
# ipm_shared, one launch, one round of FACTORED_THREADS // group lanes a
# block, group sizes and blocks an SM as measured fastest (PERF.md §6):
# the lane-shared build; the per-lane-P build, narrow, and wide a warp a
# lane with no bound on the blocks an SM (its shared memory fits two
# blocks an SM at n=27, and three blocks' register cap spilled)
SHARED_GROUP = 8
SHARED_MIN_BLOCKS = 4
LANE_P_NARROW_GROUP = 8
LANE_P_NARROW_MIN_BLOCKS = 4


def choose_group(n: int, mc: int) -> int:
    """Threads per lane for an interior point of n columns, mc rows."""
    del mc          # the row count only sets the rows per thread
    return 32 if n >= WIDE_N else NARROW_GROUP


def tri_size(n: int) -> int:
    return n * (n + 1) // 2


def tri_off(k: int, n: int) -> int:
    """Offset of column k in the column-major packed lower triangle."""
    return k * n - k * (k - 1) // 2


def tri_index(i: int, k: int, n: int) -> int:
    """Packed index of the lower-triangle entry (i, k), i >= k."""
    return tri_off(k, n) + i - k


def dense_tables(cols, n: int):
    """The dense A^T D A as a table over its target entries: for every
    lower-triangle entry (i, j) that a row touches, in packed order, the
    rows c with their nonzero slots (k, l) (cols[c][k] = i, cols[c][l] =
    j), ascending in c -- the order in which the thread-per-lane kernels
    add D_c a_k a_l.  Returns (entries, starts, contributions), each
    contribution packed c | k << 10 | l << 15."""
    ent = {}
    for c, row in enumerate(cols):
        for k, ck in enumerate(row):
            if ck < 0:
                continue
            for l in range(k + 1):
                ent.setdefault(tri_index(ck, row[l], n), []).append(
                    c | k << 10 | l << 15)
    entries = sorted(ent)
    starts, contrib = [0], []
    for e in entries:
        contrib += ent[e]
        starts.append(len(contrib))
    return entries, starts, contrib


@dataclass(frozen=True)
class GroupPlan:
    """One build's launch: group size, lanes per block, solve rounds and
    the shared-memory layout (offsets in floats)."""

    n: int
    mc: int
    band: Optional[int]
    rnz: int
    group: int
    threads: int
    lanes: int
    p: int = 0          # W rows streamed through the ring (0: none)
    m: int = 0          # u_prev entries handed over per lane (0: none)
    # hand-over through device memory (nmpc_multipass): the lane region
    # holds x, obj and u_prev only, each work region a copy of its lane's
    # Hessian; blocks an SM for __launch_bounds__ (0: any)
    compact: bool = False
    min_blocks: int = 0
    # compact: the sections of the lane's scratch row, in order (SCRATCH);
    # without "PR" the Hessian is lane-shared, one copy in the block's
    # shared memory (the linear step); "PLANT" holds the plant's state,
    # outputs and finite flag, ``plant`` floats (the step kernels)
    scratch: tuple = ()
    plant: int = 0
    # compact: each lane's own P, both triangles, staged by the block into
    # the groups' work regions (ipm_shared's per-lane build)
    lane_p: bool = False
    # compact: the W rows (each n entries and v) the lane's thread hands
    # over in its scratch row ("W"), the Gram formed by the group from a
    # copy in its work region (the wide NMPC builds); 0: none
    rows: int = 0

    @property
    def groups(self) -> int:
        return self.threads // self.group

    @property
    def rounds(self) -> int:
        return self.lanes // self.groups

    def pad(self, x: int) -> int:
        return -(-x // 32) * 32 + (self.group if self.group < 32 else 1)

    @property
    def shared_hessian(self) -> bool:
        """One lane-shared Hessian a block in shared memory (PSH), the
        groups' Hessian: a compact plan whose scratch row has none and
        that stages no per-lane P."""
        return self.compact and "PR" not in self.scratch \
            and "W" not in self.scratch and not self.lane_p

    @property
    def scratch_sections(self) -> dict:
        """The lane's scratch row: section -> (offset, floats)."""
        size = {"PR": tri_size(self.n), "Q": self.n, "OBJ": 1,
                "PLANT": self.plant, "W": self.rows * (self.n + 1)}
        out, at = {}, 0
        for name in self.scratch:
            out[name] = (at, size[name])
            at += size[name]
        return out

    @property
    def layout(self) -> dict:
        n, mc, T = self.n, self.mc, tri_size(self.n)
        AS, WS, NP = n | 1, mc | 1, n | 1
        if self.band is None:
            wd, wo = mc * self.rnz, 0
        else:
            wd, wo = n * WS, (n - self.band) * WS if self.band > 0 else 0
        slot = self.lanes * NP + self.lanes if self.p else 0
        if self.compact:
            # [x][obj][u_prev], and the step kernels' freeze decision
            keep = 1 if "PLANT" in self.scratch else 0
            lstride = (n + 1 + self.m + keep) | 1
            # [M][dx][vec], and the Hessian copied from the scratch row
            # (a per-lane P: its lower and strict upper triangles; the W
            # rows: the Hessian formed from them, then the rows)
            hess = 2 * T if self.lane_p else \
                0 if self.shared_hessian else T
            wstride = self.pad(hess + T + n + mc
                               + self.rows * (n + 1))
        else:
            lstride = self.pad(n + 1 + max(T + n + self.m, 2 * mc))
            wstride = self.pad(T + n + mc)
        # the rows' and columns' nonzero index lists (bytes): counts and
        # lists of A's rows (mc + mc n) and columns (n + n mc)
        sp = -(-(2 * mc * n + mc + n) // 4)
        sizes = [("A", mc * AS), ("WD", wd), ("WO", wo), ("SP", sp)] \
            + ([("PSH", T)] if self.shared_hessian else []) \
            + [("LANE", self.lanes * lstride),
               ("WORK", self.groups * wstride)]
        out, at = {}, 0
        for name, size in sizes:
            out["OFF_" + name] = at
            at += size
        # the ring is read before the lane and work regions are written
        out["OFF_RING"] = out["OFF_LANE"]
        at = max(at, out["OFF_RING"] + self.p * slot)
        out.update(AS=AS, WS=WS, NP=NP, SLOT=slot, LSTRIDE=lstride,
                   WSTRIDE=wstride, SMEM_FLOATS=at)
        return out

    @property
    def scratch_floats(self) -> int:
        """Floats of device scratch a lane needs (compact: what the lane's
        thread hands to its group and, in the step kernels, to the freeze,
        ``scratch_sections``)."""
        return sum(w for _, w in self.scratch_sections.values())

    @property
    def smem_bytes(self) -> int:
        return 4 * self.layout["SMEM_FLOATS"]

    def grid(self, B: int) -> int:
        """Blocks covering B lanes, the last one ragged."""
        return -(-B // self.lanes)

    def check(self):
        if self.threads % self.group or self.lanes % self.groups \
                or self.group & (self.group - 1) or not 1 <= self.group <= 32:
            raise ValueError(f"bad group plan {self}")
        if self.smem_bytes > SMEM_LIMIT:
            raise ValueError(f"group plan needs {self.smem_bytes} bytes of "
                             f"shared memory (at most {SMEM_LIMIT})")
        return self

    def config(self, cols=()) -> str:
        """``#define`` lines of the plan (and, dense, the A^T D A entry
        table of the rows' nonzero columns ``cols``)."""
        lay = self.layout
        cfg = _build.defines(KG_GROUP=self.group, KG_THREADS=self.threads,
                             KG_LANES=self.lanes, KG_ROUNDS=self.rounds,
                             KG_MIN_BLOCKS=self.min_blocks,
                             KG_SMEM_BYTES=self.smem_bytes,
                             **{"KG_" + k: v for k, v in lay.items()
                                if k != "SMEM_FLOATS"})
        if self.rows:
            cfg += _build.defines(KG_ROWS=self.rows)
        if self.compact:
            cfg += _build.defines(
                KG_SCRATCH=self.scratch_floats,
                **{"KG_S_" + k: at for k, (at, _)
                   in self.scratch_sections.items()})
        if self.band is None:
            ent, starts, contrib = dense_tables(cols, self.n)
            cfg += (_build.defines(KG_NENT=len(ent), KG_NCONTRIB=len(contrib))
                    + "".join(f"#define KG_{k} {_build.c_array(v, fmt=str)}\n"
                              for k, v in (("ENT", ent),
                                           ("ENT_START", starts),
                                           ("CONTRIB", contrib))))
        return cfg


def factored_plan(cons: Constraints, p: int) -> GroupPlan:
    """``ipm_factored``'s plan: FACTORED_THREADS threads a block, one
    round, W streamed over its p rows."""
    g = choose_group(cons.n, cons.mc)
    return GroupPlan(cons.n, cons.mc, cons.band,
                     len(cons.cols[0]) if cons.band is None else 0, g,
                     FACTORED_THREADS, FACTORED_THREADS // g, p=p,
                     min_blocks=WIDE_MIN_BLOCKS if cons.n >= WIDE_N
                     else 0).check()


def _compact_plan(cons: Constraints, m: int, group: int,
                  min_blocks: int, scratch=("PR", "Q"),
                  plant: int = 0, rows: int = 0) -> GroupPlan:
    """A lane a thread for the thread-per-lane part (the stage sweep, the
    step's front), the QPs solved ``threads // group`` lanes a round, the
    hand-over through device scratch, so that the thread-per-lane part
    keeps the SM's L1 cache (its lane-shared operands and spills live
    there)."""
    return GroupPlan(cons.n, cons.mc, cons.band,
                     len(cons.cols[0]) if cons.band is None else 0,
                     group, NMPC_THREADS, NMPC_THREADS, m=m, compact=True,
                     min_blocks=min_blocks, scratch=tuple(scratch),
                     plant=plant, rows=rows).check()


def _wide_nmpc_plan(cons: Constraints, m: int, p: int) -> GroupPlan:
    """A wide NMPC build's plan (n >= WIDE_N, the unblocked stack): the
    sweep's thread writes each pass's p projected rows [w | v] to its
    scratch row instead of a Gram in its registers (n (n+1) / 2 floats
    over the sensitivities' 6 x 30), and a warp a lane forms the Gram from
    a copy in its work region, as ``ipm_factored`` does from W."""
    return _compact_plan(cons, m, NMPC_WIDE_GROUP, NMPC_WIDE_MIN_BLOCKS,
                         ("W",), rows=p)


def nmpc_plan(cons: Constraints, m: int, p: int) -> GroupPlan:
    """``nmpc_multipass``'s plan (every pass of a step in one launch) for
    an NMPC QP of p projected rows."""
    if cons.n >= WIDE_N:
        return _wide_nmpc_plan(cons, m, p)
    return _compact_plan(cons, m, NMPC_GROUP, NMPC_MIN_BLOCKS)


def onepass_plan(cons: Constraints, m: int, p: int) -> GroupPlan:
    """``nmpc_stage``'s (every trajectory mode) and ``nmpc_pass``'s plan:
    the sweep a launch of its own, then the group solve."""
    if cons.n >= WIDE_N:
        return _wide_nmpc_plan(cons, m, p)
    return _compact_plan(cons, m, ONEPASS_GROUP, ONEPASS_MIN_BLOCKS)


def bilin_lift_plan(cons: Constraints, m: int) -> GroupPlan:
    """``bilin_lift``'s plan: the bilinear step's without the plant (its
    group size and blocks an SM measured fastest here too, PERF.md §6) --
    the front launch (a thread a lane: the lane's scaled Hessian, q and obj
    into its scratch row), then the group solve from u_prev, x0 and obj in
    the lane region."""
    return _compact_plan(cons, m, STEP_GROUP, STEP_MIN_BLOCKS,
                         ("PR", "Q", "OBJ"))


def _one_round(plan: GroupPlan, **kw) -> GroupPlan:
    """``plan`` with FACTORED_THREADS a block and one round of lanes a
    block, as ``ipm_factored`` takes them."""
    return dataclasses.replace(plan, threads=FACTORED_THREADS,
                               lanes=FACTORED_THREADS // plan.group,
                               **kw).check()


def shared_plan(cons: Constraints) -> GroupPlan:
    """``ipm_shared``'s lane-shared build: the solve alone, one round of
    lanes a block, the Hessian one copy a block, the lane region
    [x][obj]; wide (the linear controller's unblocked n=27) a warp a
    lane with no bound on the blocks an SM, as the per-lane-P build."""
    wide = cons.n >= WIDE_N
    return _one_round(_compact_plan(
        cons, 0, 32 if wide else SHARED_GROUP,
        0 if wide else SHARED_MIN_BLOCKS, ()))


def lane_p_plan(cons: Constraints) -> GroupPlan:
    """``ipm_shared``'s per-lane-P build: the solve alone, one round of
    lanes a block, each lane's P staged into its group's work region, iobj
    in the lane region."""
    wide = cons.n >= WIDE_N
    return _one_round(_compact_plan(
        cons, 1, 32 if wide else LANE_P_NARROW_GROUP,
        0 if wide else LANE_P_NARROW_MIN_BLOCKS, ()), lane_p=True)


def step_plan(cons: Constraints, m: int, plant: int,
              shared_hessian: bool) -> GroupPlan:
    """The fused steps' plan: the front launch (a thread a lane: the
    plant, ``plant`` floats of its state, outputs and finite flag, and
    ``step_fused``'s lane QP: its scaled Hessian, q and obj), then the
    group solve and the freeze.  ``linear_step_fused``
    (``shared_hessian``): the plant alone in the scratch row, the
    gradient formed by the groups (measured faster than in the front,
    PERF.md §6), the lane-shared Hessian one copy a block in shared
    memory."""
    return _compact_plan(cons, m, STEP_GROUP, STEP_MIN_BLOCKS,
                         ("PLANT",) if shared_hessian
                         else ("PR", "Q", "OBJ", "PLANT"), plant)
