// Batched interior-point QP with a lane-shared or per-lane Hessian and
// lane-shared constraint rows: a group of threads per lane
// (lane_group.cuh, ipm_group.cuh), one launch.
//
// Replaces the TPU kernel _ipm_kernel (koopman_realizations_tpu/ops/
// pallas/qp_ipm.py:299, called at :529 by solve_qp_shared_batched) in
// its two dense-objective modes, one build each:
// - lane-shared P (shared_P=True, :368-374; banded or dense A^T D A,
//   cold duals, or warm with KM_WARM_DUAL: JAX's LinearKmpc with
//   qp_dual_warm passes lam0, kmpc.py:515-518, ops/qp.py:139-146), the
//   mode the linear controller's general runner reaches:
//     min 1/2 x' Psh x + q' x  s.t.  A x <= b
//   with Psh (n, n) the host-equilibrated Hessian P / obj;
// - per-lane P (KM_LANE_P, shared_P=False, :375-379; banded or dense
//   A^T D A, cold or warm duals), reached through ops/qp.py:solve_qp with
//   a batched Hessian (the JAX _pallas_routed_solver's shared_P=not Pb):
//   each lane's P (n, n) scaled in-kernel as P * iobj + reg I with its
//   objective scale iobj = 1 / max |P| from the host; warm duals arrive
//   scaled by row * iobj (:476-479) and start as sqrt(clip(lam0, 1e-4,
//   1e4)).
// A is the row-equilibrated constraints, q and b per lane in the same
// units (q scaled by iobj on the host), the primal start x0 per lane.
// The wrapper (ops/kernels/ipm_shared.py:solve_qp_shared) does the
// equilibration, the ok mask and the multipliers' return to original
// units, as the JAX wrapper does.  The factored mode is ipm_factored.cu.
// There are no padding lanes (the JAX wrapper's P = I lanes, :496-500):
// lanes past the batch run a copy of the last lane and store nothing.
//
// Bound on an H100: compute.  At the linear controller's shape (n=12,
// mc=48, band 3, 6 iterations) a lane needs ~3e4 operations on 0.7 KB of
// lane input and output, so the f32 rate, not the memory, sets the
// floor; the per-lane P adds n*n floats (0.6 KB at n=12, 2.9 KB at n=27)
// a lane and, at n=27 with 8 iterations, ~1.6e5 operations.
//
// Design: the solve launch of lane_group.cuh alone -- q, b and x0 come
// from the caller lanes-minor, so there is no front.  The block loads the
// constraint operands into shared memory; each lane's thread puts its x0
// into the lane region; the groups solve the block's lanes' QPs, a group
// of KG_GROUP threads a lane, each thread reading q's entries and b's
// rows it owns (kl::LaneGradient, kl::LaneRhs) with loads coalesced over
// the round's lanes; the groups store s and lam, the threads x.
// - Lane-shared P: the packed lower triangle of Psh, regularized on its
//   diagonal, once a block in shared memory (kl::BlockHessian, as the
//   linear step), every group's Hessian; Psh must be symmetric in f32 (the
//   plain version reads all of it; the wrapper checks it once a call).
//   Cold duals, or (KM_WARM_DUAL) kl::LaneDuals with obj = 1 in the lane
//   region (lam0 comes scaled by row * iobj, as the per-lane build's);
//   the slack floor from the wrapper.
// - Per-lane P: before each round the block stages the round's lanes' P
//   into their groups' work regions, scaled as P * iobj + reg I: a run of
//   consecutive threads reads one entry (i, j) of consecutive lanes, so
//   every load is coalesced over the lanes (a group reading its own lane
//   would stride by B).  The lower triangle goes where the Mehrotra loop
//   keeps its Hessian, the strict upper one beside it: r_d = Pr x reads
//   all of P (kg::UpperHessian), the Newton matrix its lower triangle, as
//   the plain version does, so an f32 P that is not symmetric bit for bit
//   is solved as there.  The dual start is kl::LaneDuals with obj = 1 in the lane
//   region (lam0 comes scaled by iobj); iobj sits in the lane region
//   after it.
// The plans (ops/kernels/ipm_group.py: shared_plan, lane_p_plan) set the
// group size, lanes a block, rounds and launch bounds.
#include "lane_group.cuh"

#if defined(KM_LANE_P) && KM_LANE_P
#define KG_L_IOBJ KG_L_REST                 // lane region: iobj
#define KG_W_PU (KG_W_PR + KG_T)            // work region: P's upper part
#endif

struct IpmSharedArgs {
  km::Cons con;
  const float* Psh;    // (KM_N, KM_N) P / obj; KM_LANE_P: (KM_N, KM_N, B) P
  const float* q;      // (KM_N, B) q / obj
  const float* b;      // (KM_MC, B) b / row
  const float* x0;     // (KM_N, B) primal start
  float* x;            // (KM_N, B)
  float* s;            // (KM_MC, B)
  float* lam;          // (KM_MC, B) equilibrated multipliers
#if defined(KM_LANE_P) && KM_LANE_P
  const float* iobj;   // (B) 1 / max |P| of the lane
  const float* lam0;   // (KM_MC, B) dual start * row * iobj, or null (cold)
#elif defined(KM_WARM_DUAL) && KM_WARM_DUAL
  const float* lam0;   // (KM_MC, B) dual start * row * iobj
#endif
  long long B;
  int iters;
  float slack_floor;
};

#if defined(KM_LANE_P) && KM_LANE_P
// The round's lanes' P (lanes r0 .. r0 + KG_GROUPS - 1 of the block, lane
// r0 + k solved by group k) into the groups' work regions, scaled and
// regularized as P * iobj + reg I; every thread of the block takes part,
// consecutive threads on consecutive lanes.
__device__ __forceinline__ void stage_lane_p(const IpmSharedArgs& a,
                                             float* sm, int r0, int tid) {
  const long long B = a.B;
  for (int e = tid; e < KM_N * KM_N * KG_GROUPS; e += KG_THREADS) {
    const int ij = e / KG_GROUPS, k = e % KG_GROUPS;
    const int i = ij / KM_N, j = ij % KM_N;
    const long long b = (long long)blockIdx.x * KG_LANES + r0 + k;
    const long long bl = b < B ? b : B - 1;
    const float iobj = kg::lane_region(sm, r0 + k)[KG_L_IOBJ];
    const float v = a.Psh[ij * B + bl] * iobj + (i == j ? km::kReg : 0.0f);
    float* w = kg::work_region(sm, k);
    if (j <= i)
      w[KG_W_PR + kg::tidx(i, j)] = v;
    else
      w[KG_W_PU + kg::tidx(j, i)] = v;
  }
}

// The Hessian the block staged into the group's work region.
struct StagedHessian {
  __device__ __forceinline__ float* operator()(float* w, const float*,
                                               int) const {
    return w + KG_W_PR;
  }
};
#endif

// The block's lanes: x0 (and, per-lane P, obj = 1 and iobj) into the
// lane region; each lane's QP; x out.
struct SharedLanes {
  const IpmSharedArgs& a;
  __device__ __forceinline__ void load(float* sm, float* H, long long bl,
                                       int tid) const {
#if !(defined(KM_LANE_P) && KM_LANE_P)
    kl::BlockHessian{a.Psh}.load(sm, tid);
#endif
    if (tid >= KG_LANES) return;
#pragma unroll
    for (int i = 0; i < KM_N; ++i) H[KG_L_X + i] = a.x0[i * a.B + bl];
#if defined(KM_LANE_P) && KM_LANE_P
    H[KG_L_OBJ] = 1.0f;
    H[KG_L_IOBJ] = a.iobj[bl];
#elif defined(KM_WARM_DUAL) && KM_WARM_DUAL
    H[KG_L_OBJ] = 1.0f;
#endif
  }
  __device__ __forceinline__ void solve(const kg::Shared& sh, float* sm,
                                        int ql, int grp, int g) const {
#if defined(KM_LANE_P) && KM_LANE_P
    // the other groups may still read their last round's Hessian
    __syncthreads();
    stage_lane_p(a, sm, ql - grp, threadIdx.x);
    __syncthreads();
    kl::solve_lane_from(
        nullptr, a.B, a.iters, kl::LaneRhs{a.b, a.B}, sh, sm, ql, grp, g,
        a.slack_floor, StagedHessian{},
        kg::UpperHessian{kg::work_region(sm, grp) + KG_W_PU},
        kl::LaneGradient{a.q, a.B}, kl::LaneDuals{a.lam0, a.B},
        kl::StoreRows{a.s, a.lam, a.B});
#else
    kl::solve_lane_from(nullptr, a.B, a.iters, kl::LaneRhs{a.b, a.B}, sh, sm,
                        ql, grp, g, a.slack_floor, kl::BlockHessian{a.Psh},
                        kg::SymmetricHessian{}, kl::LaneGradient{a.q, a.B},
#if defined(KM_WARM_DUAL) && KM_WARM_DUAL
                        kl::LaneDuals{a.lam0, a.B},
#else
                        kl::ColdDuals{},
#endif
                        kl::StoreRows{a.s, a.lam, a.B});
#endif
  }
  __device__ __forceinline__ void store(const float* H, long long b) const {
#pragma unroll
    for (int i = 0; i < KM_N; ++i) a.x[i * a.B + b] = H[KG_L_X + i];
  }
};

__global__ void KG_BOUNDS ipm_shared_kernel(const IpmSharedArgs a) {
  kl::solve_block(a.con, a.B, SharedLanes{a});
}

extern "C" int km_ipm_shared(const IpmSharedArgs* args, void* stream) {
  return kl::launch_solve<IpmSharedArgs>(ipm_shared_kernel, args, stream);
}
