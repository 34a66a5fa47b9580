"""``batch_chol``'s launch plan (``ops/kernels/batch_chol.py:CholPlan``)
for both builds the ops layer's ``solve_spd`` takes at the main path's
sizes: n=27 staged through shared memory (spans of systems, a persistent
grid, a group of threads a system), n=12 direct.  Pure Python: the
design of each n, the span and its 16-byte copies, the shared memory
within the H100's 227 KB a block and 228 KB an SM, the grid over B with
a ragged last span, the alternatives ``kernel_ab.py`` times, and the
build's ``#define`` lines against what the source reads.  The kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

import re

import pytest

from koopman_realizations_torch.ops.kernels import batch_chol as BC
from koopman_realizations_torch.ops.kernels._build import CSRC
from koopman_realizations_torch.ops.kernels.ipm_group import SMEM_LIMIT
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

P = BC.CholPlan
SMS = 132                   # an H100 SXM's SMs


@pytest.mark.parametrize("n", [12, 27])
def test_plan_of_each_n(n):
    """n=27: 4 threads a system on spans of 32 systems (one round of a
    128-thread block's groups), two blocks an SM, the systems
    729 floats apart (odd: the groups' rows in distinct banks), 98 KB of
    shared memory a block (the span's systems and b, and its x); n=12:
    the direct design, 128 threads a block, no shared memory."""
    plan = BC.launch_plan(n)
    assert plan.n == n and plan.staged == (n in BC.STAGED_N)
    if n == 27:
        assert (plan.group, plan.threads, plan.span,
                plan.blocks) == (4, 128, 32, 2)
        assert plan.span == plan.threads // plan.group
        assert plan.stride == 729 and plan.stride % 2 == 1
        assert plan.smem_bytes == 4 * 32 * (729 + 27 + 27) == 100224
        assert plan.smem_bytes <= SMEM_LIMIT == 232448
        assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= BC.SM_SMEM
    else:
        assert (plan.group, plan.threads) == (0, 128)
        assert plan.smem_bytes == 0


@pytest.mark.parametrize("n,B,grid,last", [
    (27, 65536, 2 * SMS, 32), (27, 65539, 2 * SMS, 3), (27, 1003, 32, 11),
    (27, 1, 1, 1), (12, 65536, 512, 128), (12, 1000, 8, 104)])
def test_grid_and_ragged_last_span(n, B, grid, last):
    """The staged grid is persistent (two blocks an SM, or a block a span
    where there are fewer spans), the direct one a block per 128 systems;
    the last span (or block) holds what is left of B.  Each span's copy
    starts on 16 bytes (its first system at a multiple of 4 systems), and
    its b and x too."""
    plan = BC.launch_plan(n)
    assert plan.grid(B, SMS) == grid
    per = plan.span if plan.staged else plan.threads
    units = -(-B // per)
    assert B - (units - 1) * per == last
    if plan.staged:
        assert units == plan.spans(B)
        assert plan.span % 4 == 0
        assert (plan.span * n * n) % 4 == 0 and (plan.span * n) % 4 == 0
        # each block walks spans blockIdx, + grid, ...: every span once
        walked = sorted(s for blk in range(grid)
                        for s in range(blk, units, grid))
        assert walked == list(range(units))


@pytest.mark.parametrize("n", range(1, 33))
def test_every_small_n_has_a_plan(n):
    """``launch_plan`` checks for every n up to 32: the staged design
    only at the measured n=27, the direct design (any n, no shared
    memory) everywhere else."""
    plan = BC.launch_plan(n)
    assert plan.n == n and plan.staged == (n == 27)
    if not plan.staged:
        assert (plan.group, plan.threads, plan.smem_bytes) == (0, 128, 0)


# alternatives of the kinds kernel_ab.py times (CholPlan fields)
ALTERNATIVES = [P(*f) for n, fields in (
    (27, ((0, 128), (4, 256, 64, 1), (8, 256, 32, 2), (16, 256, 16, 2),
          (32, 128, 4, 0))),
    (12, ((0, 256), (2, 64, 32, 0), (4, 128, 32, 0), (8, 256, 32, 0))))
    for f in ((n,) + t for t in fields)]


@pytest.mark.parametrize("plan", ALTERNATIVES, ids=str)
def test_alternatives_fit(plan):
    """Each alternative checks: the shared memory a block and the blocks
    an SM fit; a staged plan's group is a power of two of at most a warp,
    its groups one round over the span; n=12's staged systems pad to 148
    floats (a multiple of 4 for the 16-byte copies, 20 mod 32: at most
    4-way bank conflicts)."""
    plan.check()
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= BC.SM_SMEM
    if plan.staged:
        assert 1 < plan.group <= 32 and plan.group & (plan.group - 1) == 0
        assert plan.span == plan.threads // plan.group
    if plan.staged and plan.n == 12:
        assert plan.stride == 148 and plan.stride % 32 == 20


@pytest.mark.parametrize("plan", [
    P(27, 4, 120, 30, 1),              # span not a multiple of 4
    P(27, 4, 512, 128, 1),             # a 128-system span: 392 KB
    P(27, 4, 128, 16, 2),              # a span short of the groups
    P(27, 16, 128, 32, 1),             # a span past one round
    P(27, 64, 128, 2, 1),              # a group wider than a warp
    P(27, 6, 192, 32, 1),              # a group not a power of two
    P(27, 1, 32, 32, 1),               # a thread a system: dropped
    P(27, 4, 256, 64, 2),              # two blocks' 394 KB an SM
    P(27, 0, 100)], ids=str)           # not a whole number of warps
def test_bad_plans_refused(plan):
    with pytest.raises(ValueError):
        plan.check()


@pytest.mark.parametrize("n", [12, 27])
def test_kernel_spec_carries_the_plan(n):
    """The build's ``#define`` lines are its plan's, and the source reads
    each of them: the design, the threads, and (staged) the span,
    system stride and shared memory, which the C entry sets as the
    kernel's dynamic shared memory."""
    plan = BC.launch_plan(n)
    cfg = BC.kernel_spec(n).config
    assert plan.config() in cfg
    defs = dict(re.findall(r"#define (\w+) (\d+)\n", cfg))
    assert defs["KM_N"] == str(n) and defs["KC_GROUP"] == str(plan.group)
    assert defs["KC_THREADS"] == str(plan.threads)
    src = (CSRC / BC.SOURCE).read_text()
    for key in defs:
        assert key in src, key
    if plan.staged:
        assert defs["KC_SMEM_BYTES"] == str(plan.smem_bytes)
        assert defs["KC_STRIDE"] == str(plan.stride)
        assert re.search(r"cudaFuncSetAttribute\(\s*batch_chol_kernel,\s*"
                         r"cudaFuncAttributeMaxDynamicSharedMemorySize,\s*"
                         r"KC_SMEM_BYTES\)", src)
    else:
        assert "KC_SPAN" not in defs
    assert BC.kernel_spec(12) != BC.kernel_spec(27)
