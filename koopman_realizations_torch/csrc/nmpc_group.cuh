// The NMPC kernels' skeleton on the cooperative interior point: each
// thread sweeps one lane's stages (nmpc_device.cuh), hands the pass's
// scaled Hessian and q over through a device scratch row of its own, and
// the block then solves its lanes' QPs KG_THREADS / KG_GROUP at a time, a
// group of KG_GROUP threads a lane (ipm_group.cuh).  Three kernels use
// it: nmpc_multipass.cu (every SQP pass of a step in one launch),
// nmpc_stage.cu and nmpc_pass.cu (one pass a launch).
//
// The three differ in three things, each a parameter here:
// - the Levenberg term of q: q0c * x_prev (multipass, from the previous
//   pass's x), or a per-lane q0 from memory or none (the one-pass
//   kernels), added as 2 W^T v + term before the objective scale;
// - the dual start: cold (lam = 1), or sqrt(clip(lam0_row / obj, 1e-4,
//   1e4)) from a per-lane lam0 in row-equilibrated units, the lane's obj
//   read from its lane region;
// - the primal start in the lane region's x slot: x_prev (multipass) or
//   the shipped x0 (the one-pass kernels), each written by the lane's
//   thread with loads coalesced over the lanes.
//
// Layout (ops/kernels/ipm_group.py, the compact plan): the lane region
// holds [x: n][obj: 1][u_prev: m]; the lane's scratch row (row b of the
// scratch, b the lane's place in the grid) [Pr: T][q: n]; the group's
// work region [M: T][dx: n][vec: mc][Pr: T], the Hessian copied from
// the scratch row.  The scratch row is written and read back within the
// launch (an L2 round trip), so that the sweep keeps the SM's L1 cache
// for its lane-shared operands and spills.
//
// Lanes past the batch sweep a copy of the last lane, take part in every
// barrier and shuffle of the block's solves, and store nothing.
//
// The one-pass kernels run in two launches on the stream: a sweep kernel
// (a thread per lane, 128-thread launch bounds, no cap on its registers)
// that writes the scratch rows and obj, then the group solve under the
// plan's launch bounds.  Under those bounds (128 registers at 4 blocks an
// SM) a sweep in the solve's launch spills: it took 2-4x its
// thread-per-lane time there (PERF.md §5, §6).
#pragma once

#include "ipm_group.cuh"
#include "nmpc_device.cuh"

#define KG_H_UP KG_L_REST
#define KG_W_PR (KG_T + KM_N + KM_MC)

namespace kn {

// ------------------------------------------------------- the Levenberg term
// q0c * x_prev (multipass) ...
struct LevenbergTerm {
  const float* q0c;
  const float (&xp)[KM_N];
  __device__ __forceinline__ float operator()(int i) const {
    return km::ldg(q0c + i) * xp[i];
  }
};
// ... or a per-lane q0 (KM_N rows, lanes-minor; the pointer at the lane),
// none where null.
struct LaneTerm {
  const float* q0;
  long long B;
  __device__ __forceinline__ float operator()(int i) const {
    return q0 ? q0[i * B] : 0.0f;
  }
};

// ----------------------------------------------------------- the dual start
// Each source gives, for lane b, a row function c -> lam_c.
struct ColdDuals {
  struct Lane {
    __device__ __forceinline__ float operator()(int) const { return 1.0f; }
  };
  __device__ __forceinline__ Lane lane(long long, const float*) const {
    return Lane{};
  }
};
// lam0 (KM_MC rows, lanes-minor, row-equilibrated) or, where null, cold:
// sqrt(clip(lam0_row * (1 / obj), 1e-4, 1e4)), obj from the lane region.
struct LaneDuals {
  const float* lam0;
  long long B;
  struct Lane {
    const float* p;
    long long B;
    float iobj;
    __device__ __forceinline__ float operator()(int c) const {
      return p ? km::ksqrt(km::nclip(p[c * B] * iobj, 1e-4f, 1e4f)) : 1.0f;
    }
  };
  __device__ __forceinline__ Lane lane(long long b, const float* H) const {
    return Lane{lam0 ? lam0 + b : nullptr, B,
                lam0 ? km::kdiv(1.0f, H[KG_L_OBJ]) : 1.0f};
  }
};

// The pass's QP from the swept Gram, as the thread-per-lane kernels
// formed it before their Mehrotra loop: P = 2 (W^T W + diag(rdiag)),
// q = 2 W^T v + term, the objective scale and the regularized Hessian;
// the Hessian's lower triangle and q into the lane's scratch row H.
// Returns obj.
template <class Term>
__device__ __forceinline__ float hand_over(float (&Pr)[KM_N][KM_N],
                                           float (&q)[KM_N],
                                           const Term& term, float* H) {
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    q[i] = 2.0f * q[i] + term(i);
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      Pr[i][k] *= 2.0f;
      Pr[k][i] = Pr[i][k];
    }
  }
  const float obj = km::diag_obj_scale(Pr);
  const float iobj = km::kdiv(1.0f, obj);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    H[KG_T + i] = q[i] * iobj;
#pragma unroll
    for (int k = 0; k <= i; ++k)
      H[kg::tidx(i, k)] = Pr[i][k] * iobj + (i == k ? km::kReg : 0.0f);
  }
  return obj;
}

// Lane b's scratch row.
__device__ __forceinline__ float* scratch_row(float* scratch, long long b) {
  return scratch + b * (KG_T + KM_N);
}

// One lane's pass QP by its group: the Hessian from the lane's scratch
// row into the work region, q to its owners, the right-hand side
// b = cFr - F0r u_prev and the dual start for the group's rows, the
// Mehrotra loop from the lane region's x (updated in place); with
// ``last`` the group stores s and lam of a lane in the batch.  Args has
// op, scratch, s, lam, B and iters.
template <class Args, class Duals>
__device__ __forceinline__ void solve_lane(const Args& a,
                                           const kg::Shared& sh, float* sm,
                                           int ql, int grp, int g, bool last,
                                           float slack_floor,
                                           const Duals& duals) {
  const km::Nmpc& op = a.op;
  float* H = kg::lane_region(sm, ql);
  float* w = kg::work_region(sm, grp);
  const kg::Lane L{w + KG_W_PR, H + KG_L_X, w, w + KG_T, w + KG_T + KM_N};
  const long long b = (long long)blockIdx.x * KG_LANES + ql;
  const float* hs = scratch_row(a.scratch, b);
  for (int t = g; t < KG_T; t += KG_GROUP) L.Pr[t] = hs[t];
  float q[KG_NO], rhs[KG_R], s[KG_R], lam[KG_R];
#pragma unroll
  for (int o = 0; o < KG_NO; ++o) {
    const int i = g + KG_GROUP * o;
    q[o] = i < KM_N ? hs[KG_T + i] : 0.0f;
  }
  const auto lam0 = duals.lane(b < a.B ? b : a.B - 1, H);
#pragma unroll
  for (int k = 0; k < KG_R; ++k) {
    const int c = g + KG_GROUP * k;
    float bc = 0.0f, lc = 1.0f;
    if (c < KM_MC) {
      bc = km::ldg(op.cFr + c);
#pragma unroll
      for (int j = 0; j < KM_M; ++j)
        bc = bc - km::ldg(op.F0r + c * KM_M + j) * H[KG_H_UP + j];
      lc = lam0(c);
    }
    rhs[k] = bc;
    lam[k] = lc;
  }
  kg::gsync();
  kg::mehrotra(sh, L, g, a.iters, slack_floor, q, rhs, s, lam);
  if (last && b < a.B) {
#pragma unroll
    for (int k = 0; k < KG_R; ++k) {
      const int c = g + KG_GROUP * k;
      if (c < KM_MC) {
        a.s[c * a.B + b] = s[k];
        a.lam[c * a.B + b] = lam[k];
      }
    }
  }
}

// ------------------------------------------------------ one pass a launch
// Args (StageArgs, PassArgs) has op, zeta, up, sqRef, x0, q0, lam0, x, s,
// lam, obj, scratch, B, sqRef_lanes, iters and slack_floor; Sweep(b, zeta,
// up, sq, sq_step, Pr, q) runs lane b's condense_sweep over its source.

// The sweep launch (KG_LANES == KG_THREADS: a thread a lane): every lane
// of the grid swept (lanes past the batch along the last lane's data) and
// handed over into its scratch row, obj stored for the lanes in the batch.
template <class Args, class Sweep>
__device__ __forceinline__ void sweep_pass(const Args& a, const Sweep& sweep) {
  const long long B = a.B;
  const long long b = (long long)blockIdx.x * KG_LANES + threadIdx.x;
  const bool live = b < B;
  const long long bl = live ? b : B - 1;
  float up[KM_M], zeta[KN_NZ];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.up[j * B + bl];
#pragma unroll
  for (int i = 0; i < KN_NZ; ++i) zeta[i] = a.zeta[i * B + bl];
  const float* sq = a.sqRef_lanes ? a.sqRef + bl : a.sqRef;
  const long long sq_step = a.sqRef_lanes ? B : 1;
  float Pr[KM_N][KM_N], q[KM_N];
  sweep(bl, zeta, up, sq, sq_step, Pr, q);
  const float obj = hand_over(Pr, q, LaneTerm{a.q0 ? a.q0 + bl : nullptr, B},
                              scratch_row(a.scratch, b));
  if (live) a.obj[b] = obj;
}

// The solve launch: each lane's u_prev, x0 and obj (from the sweep
// launch) into its lane region; the block's lanes' pass QPs, a round of
// KG_GROUPS lanes at a time; x out, coalesced over the lanes.
template <class Args>
__device__ __forceinline__ void one_pass(const Args& a) {
  float* sm = kg::dynamic_smem();
  const int tid = threadIdx.x;
  const int grp = tid / KG_GROUP, g = tid % KG_GROUP;
  const long long B = a.B;
  const long long b = (long long)blockIdx.x * KG_LANES + tid;
  const bool live = b < B;
  const long long bl = live ? b : B - 1;
  const kg::Shared sh = kg::shared_view(sm);
  float* H = kg::lane_region(sm, tid);
  kg::load_shared(a.op.con, sh, tid);
#pragma unroll
  for (int j = 0; j < KM_M; ++j) H[KG_H_UP + j] = a.up[j * B + bl];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) H[KG_L_X + i] = a.x0[i * B + bl];
  H[KG_L_OBJ] = a.obj[bl];
  __syncthreads();
#pragma unroll 1
  for (int round = 0; round < KG_ROUNDS; ++round)
    solve_lane(a, sh, sm, round * KG_GROUPS + grp, grp, g, true,
               a.slack_floor, LaneDuals{a.lam0, B});
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = H[KG_L_X + i];
}

// The one-pass C entry: the sweep launch, then the block's solves on the
// same stream.
template <class Args>
int launch_one_pass(void (*sweep)(Args), void (*solve)(Args),
                    const Args* args, void* stream) {
  if (args->B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      solve, cudaFuncAttributeMaxDynamicSharedMemorySize, KG_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((args->B + KG_LANES - 1) / KG_LANES);
  const cudaStream_t st = (cudaStream_t)stream;
  sweep<<<grid, KG_THREADS, 0, st>>>(*args);
  solve<<<grid, KG_THREADS, KG_SMEM_BYTES, st>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace kn
