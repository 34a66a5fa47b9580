// The cooperative interior point: one lane's Mehrotra predictor-corrector
// run by a group of KG_GROUP threads, with the lane's matrices in shared
// memory (ipm_factored.cu; through lane_group.cuh nmpc_multipass.cu,
// nmpc_stage.cu, nmpc_pass.cu, step_fused.cu, linear_step_fused.cu,
// bilin_lift.cu, bilin.cu and ipm_shared.cu).  It is the port's only
// interior point: no kernel runs a QP one thread per lane.
//
// It replaces the thread-per-lane loop the port first had, which kept
// the Hessian, M and L (3 n^2 floats) in one thread's registers or, at
// n=27, in thread-local memory.  Both compute the TPU kernels'
// _mehrotra_loop (qp_ipm.py:236-296) with the banded or dense A^T D A
// (:209-233), _chol_lanes (:143-176) and _chol_solve_lanes (:179-206).
//
// Design, for Hopper:
// - A lane's scaled Hessian Pr and its Newton matrix M, factored in place
//   into L, are packed lower triangles (column-major, T = n (n+1) / 2
//   floats each) in shared memory: 0.6 KB at n=12, 3.0 KB at n=27.
// - ipm_factored.cu stages its lanes' W in the block's shared memory and
//   keeps a lane region of [x][obj][Pr | q | u_prev  or  s | lam]; the
//   NMPC kernels' compact plan keeps [x][obj][u_prev] a lane, a lane a
//   thread in their thread-per-lane stage sweep, the Hessian and q handed
//   from the lane's thread to its group through a row of device scratch
//   (nmpc_multipass in one launch a step; nmpc_stage and nmpc_pass in a
//   sweep launch and a solve launch; the fused steps in a front launch
//   and a solve launch), the Hessian copied into the group's work region
//   or, lane-shared (the linear step), one copy a block
//   (ops/kernels/ipm_group.py lays out both).
// - The lane-shared operands -- A (odd row stride), the banded A^T D A
//   tables Wd/Wo (odd stride) or the dense rows' nonzero values, and A's
//   nonzero structure -- are loaded into shared memory once per block
//   (ipm_group.py lays the block out).
// - Row c of the lane's constraint vectors (s, lam, b, r_p, the
//   directions) lives in registers of thread c % G, a few rows a thread;
//   entry i of its n-vectors (q, r_d, dx) in registers of thread i % G.
//   x and dx are mirrored in shared memory for the products with A.
// - A x: each thread its rows against the shared x.  A^T v: the rows'
//   values go through shared memory and each owner sums its column over
//   the rows in row order.  The AtDA, the matrix-vector products with Pr
//   and the Cholesky run over the packed entries, column by column, with
//   __syncwarp between columns; the triangular solves run entry by entry
//   with a shuffle from the entry's owner.  The residual max and
//   max_step reduce over the group with xor shuffles (min and max are
//   order-free); mu and mu_aff run as one fma chain over the rows in row
//   order, each row shuffled from its owner.
// - Tensor cores are not used: the per-lane products are 12-27 wide, and
//   the Newton matrix needs f32 -- D = lam / s reaches its 1e14 clip on
//   degenerate lanes, and TF32 keeps about three digits.  The bound stays
//   operations at the f32 rate or bytes at the memory rate.
//
// Numerics are those of the thread-per-lane loop: the same fixed
// iteration count, kReg, kMuFloor freeze, clips, IEEE divides and square
// roots, NaN-propagating min/max in every reduction (km::nmin/nmax), the
// isfinite guards on the update; every product, solve and sum takes its
// terms in the same order (the products with A skip only its exact
// zeros).  Built with -fmad=false, each kernel's result was bitwise its
// thread-per-lane predecessor's on the card (kernel_ab.py, held to the
// parent tree in each redesign).  nvcc's default contraction fuses
// different multiply-add pairs in the two loops, so the default builds
// differed in the last bits from the first iteration on, and by more on
// lanes whose f32 minimizer is poorly determined.  There are
// no atomics, and a group's shuffles never leave its lane.  Every thread
// of a block runs the same sequence of barriers and shuffles: lanes past
// the batch compute on their zero-filled (or clamped) inputs and store
// nothing.
#pragma once

#include <cuda_pipeline.h>

#include "kmpc_device.cuh"

#ifndef KG_GROUP
#error "ipm_group.cuh needs the group plan (ops/kernels/ipm_group.py)"
#endif

#define KG_T (KM_N * (KM_N + 1) / 2)                  // packed triangle
#define KG_R ((KM_MC + KG_GROUP - 1) / KG_GROUP)      // rows per thread
#define KG_NO ((KM_N + KG_GROUP - 1) / KG_GROUP)      // entries per thread
#define KG_NT ((KG_T + KG_GROUP - 1) / KG_GROUP)      // packed per thread
#define KG_GROUPS (KG_THREADS / KG_GROUP)             // groups per block

// The kernels' launch bounds: KG_THREADS a block and, where the plan
// sets it, KG_MIN_BLOCKS blocks an SM (which caps the registers).
#if KG_MIN_BLOCKS > 0
#define KG_BOUNDS __launch_bounds__(KG_THREADS, KG_MIN_BLOCKS)
#else
#define KG_BOUNDS __launch_bounds__(KG_THREADS)
#endif

namespace kg {

using km::kdiv;
using km::ksqrt;
using km::nclip;
using km::nmax;
using km::nmin;

constexpr unsigned kFull = 0xffffffffu;

// The group's barrier and shuffles (every thread of the warp takes part;
// a shuffle's width keeps it inside the group).
__device__ __forceinline__ void gsync() { __syncwarp(); }
__device__ __forceinline__ float gshfl(float v, int src) {
  return __shfl_sync(kFull, v, src, KG_GROUP);
}
__device__ __forceinline__ float gmin(float v) {
#pragma unroll
  for (int m = KG_GROUP / 2; m > 0; m >>= 1)
    v = nmin(v, __shfl_xor_sync(kFull, v, m, KG_GROUP));
  return v;
}
__device__ __forceinline__ float gmax(float v) {
#pragma unroll
  for (int m = KG_GROUP / 2; m > 0; m >>= 1)
    v = nmax(v, __shfl_xor_sync(kFull, v, m, KG_GROUP));
  return v;
}

// The block's dynamic shared memory (KG_SMEM_BYTES, set by the launch).
__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ float4 kg_dynamic_smem[];
  return reinterpret_cast<float*>(kg_dynamic_smem);
}

// Asynchronous 4-byte copy into shared memory (cp.async): zero-filled
// where ``valid`` is false (src must still be a valid address).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  __pipeline_memcpy_async(dst, src, sizeof(float), valid ? 0 : sizeof(float));
}

// Column-major packed lower triangle: column k starts at off(k).
__host__ __device__ constexpr int off(int k) {
  return k * KM_N - k * (k - 1) / 2;
}
__device__ __forceinline__ int tidx(int i, int k) { return off(k) + i - k; }
// The column k of packed entry t (t = tidx(i, k), so i = k + t - off(k)).
__device__ __forceinline__ int tcol(int t) {
  int k = 0;
  while (off(k + 1) <= t) ++k;
  return k;
}

// The lane-shared operands in shared memory.
// A's nonzero structure: each row's columns and each column's rows,
// ascending, with their counts; a product with A skips only exact zeros
// of the lane-shared rows, so it sums the same terms in the same order.
struct Shared {
  float* A;                 // (KM_MC, KG_AS)
  float* Wd;                // banded (KM_N, KG_WS); dense (KM_MC, KM_RNZ)
  float* Wo;                // (KM_N - KM_BAND, KG_WS)
  unsigned char* row_cnt;   // (KM_MC)
  unsigned char* row_cols;  // (KM_MC, KM_N)
  unsigned char* col_cnt;   // (KM_N)
  unsigned char* col_rows;  // (KM_N, KM_MC)
};

__device__ __forceinline__ Shared shared_view(float* sm) {
  unsigned char* sp = reinterpret_cast<unsigned char*>(sm + KG_OFF_SP);
  return Shared{sm + KG_OFF_A, sm + KG_OFF_WD, sm + KG_OFF_WO, sp,
                sp + KM_MC, sp + KM_MC + KM_MC * KM_N,
                sp + 2 * KM_MC + KM_MC * KM_N};
}

// Load the lane-shared operands, every thread of the block taking part
// (coalesced reads), and derive A's structure from the loaded copy (the
// caller synchronizes the block before the structure is read).
__device__ __forceinline__ void load_shared(const km::Cons& con,
                                            const Shared& sh, int tid) {
  for (int e = tid; e < KM_MC * KM_N; e += KG_THREADS)
    sh.A[(e / KM_N) * KG_AS + e % KM_N] = __ldg(con.A + e);
#if KM_BAND < 0
  for (int e = tid; e < KM_MC * KM_RNZ; e += KG_THREADS)
    sh.Wd[e] = __ldg(con.Wd + e);
#else
  for (int e = tid; e < KM_N * KM_MC; e += KG_THREADS)
    sh.Wd[(e / KM_MC) * KG_WS + e % KM_MC] = __ldg(con.Wd + e);
#if KM_BAND > 0
  for (int e = tid; e < (KM_N - KM_BAND) * KM_MC; e += KG_THREADS)
    sh.Wo[(e / KM_MC) * KG_WS + e % KM_MC] = __ldg(con.Wo + e);
#endif
#endif
  // A's structure from its shared copy
  __syncthreads();
  for (int c = tid; c < KM_MC; c += KG_THREADS) {
    int cnt = 0;
    for (int i = 0; i < KM_N; ++i)
      if (sh.A[c * KG_AS + i] != 0.0f) sh.row_cols[c * KM_N + cnt++] = i;
    sh.row_cnt[c] = cnt;
  }
  for (int i = tid; i < KM_N; i += KG_THREADS) {
    int cnt = 0;
    for (int c = 0; c < KM_MC; ++c)
      if (sh.A[c * KG_AS + i] != 0.0f) sh.col_rows[i * KM_MC + cnt++] = c;
    sh.col_cnt[i] = cnt;
  }
}

// One lane as its group sees it.
struct Lane {
  float* Pr;    // (KG_T) regularized, objective-scaled Hessian, packed
  float* x;     // (KM_N) primal iterate
  float* M;     // (KG_T) Newton matrix, factored in place
  float* dx;    // (KM_N) direction, for A dx
  float* vec;   // (KM_MC) row vector being transposed
};

// The lane region of block lane ``q`` and the work region of group
// ``grp`` (ipm_group.py: [x][obj][Pr | q | u_prev  or  s | lam]).
__device__ __forceinline__ float* lane_region(float* sm, int q) {
  return sm + KG_OFF_LANE + q * KG_LSTRIDE;
}
__device__ __forceinline__ float* work_region(float* sm, int grp) {
  return sm + KG_OFF_WORK + grp * KG_WSTRIDE;
}
#define KG_L_X 0
#define KG_L_OBJ KM_N
#define KG_L_REST (KM_N + 1)

__device__ __forceinline__ Lane lane_view(float* sm, int q, int grp) {
  float* l = lane_region(sm, q);
  float* w = work_region(sm, grp);
  return Lane{l + KG_L_REST, l + KG_L_X, w, w + KG_T, w + KG_T + KM_N};
}

// Pr(i, j) of the symmetric Hessian from its lower triangle.
__device__ __forceinline__ float hess(const Lane& L, int i, int j) {
  return j <= i ? L.Pr[tidx(i, j)] : L.Pr[tidx(j, i)];
}

// How the product r_d = Pr x reads the Hessian: its lower triangle for
// both (a symmetric Pr, every build but one) ...
struct SymmetricHessian {
  __device__ __forceinline__ float operator()(const Lane& L, int i,
                                              int j) const {
    return hess(L, i, j);
  }
};
// ... or the lower triangle below the diagonal and the strict upper one
// above it, Pu[tidx(j, i)] = Pr(i, j) for i < j (ipm_shared's per-lane P,
// which need not be symmetric: the product reads all of it, the Newton
// matrix its lower triangle, as the plain version does).
struct UpperHessian {
  const float* Pu;
  __device__ __forceinline__ float operator()(const Lane& L, int i,
                                              int j) const {
    return j <= i ? L.Pr[tidx(i, j)] : Pu[tidx(j, i)];
  }
};

// (A v)_c for a shared n-vector v, over row c's nonzeros in order.
__device__ __forceinline__ float dot_row(const Shared& sh, int c,
                                         const float* v) {
  const float* a = sh.A + c * KG_AS;
  const unsigned char* cols = sh.row_cols + c * KM_N;
  const int cnt = sh.row_cnt[c];
  float acc = 0.0f;
  for (int j = 0; j < cnt; ++j) {
    const int i = cols[j];
    acc = fmaf(a[i], v[i], acc);
  }
  return acc;
}

// (A^T v)_i for the shared row vector v, over column i's nonzeros in
// row order.
__device__ __forceinline__ float dot_col(const Shared& sh, int i,
                                         const float* v) {
  const unsigned char* rows = sh.col_rows + i * KM_MC;
  const int cnt = sh.col_cnt[i];
  float acc = 0.0f;
  for (int j = 0; j < cnt; ++j) {
    const int c = rows[j];
    acc = fmaf(sh.A[c * KG_AS + i], v[c], acc);
  }
  return acc;
}

// M = Pr + A^T diag(D) A over the packed lower triangle, D in L.vec.
// Banded: each diagonal and off-band entry is one thread's sum over the
// rows.  Dense: each touched entry adds its rows' D_c a_k a_l in row
// order (the entry table KG_ENT/KG_ENT_START/KG_CONTRIB of the build).
#if KM_BAND < 0
__device__ const int kEnt[KG_NENT] = KG_ENT;
__device__ const int kEntStart[KG_NENT + 1] = KG_ENT_START;
__device__ const int kContrib[KG_NCONTRIB] = KG_CONTRIB;
#endif
__device__ __forceinline__ void form_newton(const Shared& sh, const Lane& L,
                                            int g) {
  for (int t = g; t < KG_T; t += KG_GROUP) L.M[t] = L.Pr[t];
  gsync();
#if KM_BAND < 0
  for (int e = g; e < KG_NENT; e += KG_GROUP) {
    const int t = __ldg(kEnt + e);
    float m = L.M[t];
    const int end = __ldg(kEntStart + e + 1);
    for (int j = __ldg(kEntStart + e); j < end; ++j) {
      const int pc = __ldg(kContrib + j);
      const int c = pc & 1023, k = (pc >> 10) & 31, l = pc >> 15;
      const float da = L.vec[c] * sh.Wd[c * KM_RNZ + k];
      m = fmaf(da, sh.Wd[c * KM_RNZ + l], m);
    }
    L.M[t] = m;
  }
#else
  // the tables' entries of column i are zero off A's rows with a
  // nonzero in column i: sum over those rows, in row order
  constexpr int kTasks = KM_N + (KM_BAND > 0 ? KM_N - KM_BAND : 0);
  for (int task = g; task < kTasks; task += KG_GROUP) {
    const bool diag = task < KM_N;
    const int i = diag ? task : task - KM_N;
    const float* w = diag ? sh.Wd + i * KG_WS : sh.Wo + i * KG_WS;
    const unsigned char* rows = sh.col_rows + i * KM_MC;
    const int cnt = sh.col_cnt[i];
    float acc = 0.0f;
    for (int j = 0; j < cnt; ++j) {
      const int c = rows[j];
      acc = fmaf(w[c], L.vec[c], acc);
    }
    const int t = diag ? tidx(i, i) : tidx(i + KM_BAND, i);
    L.M[t] += acc;
  }
#endif
  gsync();
}

// Lower Cholesky in place, column by column (one IEEE reciprocal of an
// exact sqrt per column), each thread its own rows (i % G == g): row i's
// entry of column j is M_ij - sum_{k<j} L_ik L_jk, subtracted in k order
// -- the same operations, in the same order, as the right-looking update
// of qp_ipm.py:143-176 -- scaled by the column's reciprocal, which every
// thread forms from the diagonal's owner's value.  One barrier a column.
__device__ __forceinline__ void chol(const Lane& L, int g) {
#pragma unroll
  for (int j = 0; j < KM_N; ++j) {
    float acc[KG_NO];
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      const int r = i < KM_N ? (i > j ? i : j) : KM_N - 1;
      float a = L.M[tidx(r, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) a -= L.M[tidx(r, k)] * L.M[tidx(j, k)];
      acc[o] = a;
    }
    const float rd = kdiv(1.0f, ksqrt(gshfl(acc[j / KG_GROUP], j % KG_GROUP)));
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      if (i >= j && i < KM_N) L.M[tidx(i, j)] = acc[o] * rd;
    }
    gsync();
  }
}

// Solve L L^T x = r for r held by the owners (entry i on thread i % G),
// entry by entry: the owner's value is shuffled to the group, every
// thread divides by the diagonal and updates the entries it owns.
__device__ __forceinline__ void chol_solve(const Lane& L, int g,
                                           float (&r)[KG_NO]) {
#pragma unroll
  for (int k = 0; k < KM_N; ++k) {
    const float yk = kdiv(gshfl(r[k / KG_GROUP], k % KG_GROUP),
                          L.M[tidx(k, k)]);
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      if (i == k) r[o] = yk;
      else if (i > k && i < KM_N) r[o] -= L.M[tidx(i, k)] * yk;
    }
  }
#pragma unroll
  for (int i = KM_N - 1; i >= 0; --i) {
    const float xi = kdiv(gshfl(r[i / KG_GROUP], i % KG_GROUP),
                          L.M[tidx(i, i)]);
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int j = g + KG_GROUP * o;
      if (j == i) r[o] = xi;
      else if (j < i) r[o] -= L.M[tidx(i, j)] * xi;
    }
  }
}

// sum_c a_c b_c over the lane's rows as one fma chain in row order (the
// thread-per-lane loop's order): each row's pair is shuffled from its
// owner, and every thread of the group forms the same chain.
__device__ __forceinline__ float row_dot(const float (&a)[KG_R],
                                         const float (&b)[KG_R]) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < KM_MC; ++c)
    acc = fmaf(gshfl(a[c / KG_GROUP], c % KG_GROUP),
               gshfl(b[c / KG_GROUP], c % KG_GROUP), acc);
  return acc;
}

// Largest alpha in (0, 1] keeping v + alpha dv >= 0.01 v over the
// group's rows (NaN propagates).
__device__ __forceinline__ float max_step(int g, const float (&v)[KG_R],
                                          const float (&dv)[KG_R]) {
  float mn = INFINITY;
#pragma unroll
  for (int k = 0; k < KG_R; ++k)
    if (g + KG_GROUP * k < KM_MC && dv[k] < 0.0f)
      mn = nmin(mn, kdiv(-v[k], dv[k]));
  return nmin(1.0f, 0.99f * gmin(mn));
}

// One Newton direction for the complementarity residual rsl.
__device__ __forceinline__ void direction(const Shared& sh, const Lane& L,
                                          int g, const float (&rd)[KG_NO],
                                          const float (&rp)[KG_R],
                                          const float (&s)[KG_R],
                                          const float (&lam)[KG_R],
                                          const float (&rsl)[KG_R],
                                          float (&dx)[KG_NO],
                                          float (&ds)[KG_R],
                                          float (&dlam)[KG_R]) {
#pragma unroll
  for (int k = 0; k < KG_R; ++k) {
    const int c = g + KG_GROUP * k;
    if (c < KM_MC) L.vec[c] = kdiv(-rsl[k] + lam[k] * rp[k], s[k]);
  }
  gsync();
#pragma unroll
  for (int o = 0; o < KG_NO; ++o) {
    const int i = g + KG_GROUP * o;
    dx[o] = i < KM_N ? -rd[o] - dot_col(sh, i, L.vec) : 0.0f;
  }
  chol_solve(L, g, dx);
#pragma unroll
  for (int o = 0; o < KG_NO; ++o) {
    const int i = g + KG_GROUP * o;
    if (i < KM_N) L.dx[i] = dx[o];
  }
  gsync();
#pragma unroll
  for (int k = 0; k < KG_R; ++k) {
    const int c = g + KG_GROUP * k;
    if (c < KM_MC) {
      ds[k] = -rp[k] - dot_row(sh, c, L.dx);
      dlam[k] = kdiv(-rsl[k] - lam[k] * ds[k], s[k]);
    } else {
      ds[k] = dlam[k] = 0.0f;
    }
  }
  gsync();
}

// Fixed-iteration Mehrotra predictor-corrector of one lane: L.Pr holds
// the scaled, regularized Hessian (its lower triangle; hdot reads it for
// r_d), q the scaled linear term (owners), b the equilibrated right-hand
// side and lam the dual start (rows), L.x the primal start.  On return
// L.x, s and lam hold the iterate.
template <class HDot = SymmetricHessian>
__device__ __forceinline__ void mehrotra(const Shared& sh, const Lane& L,
                                         int g, int iters, float slack_floor,
                                         const float (&q)[KG_NO],
                                         const float (&b)[KG_R],
                                         float (&s)[KG_R],
                                         float (&lam)[KG_R],
                                         const HDot& hdot = HDot()) {
#pragma unroll
  for (int k = 0; k < KG_R; ++k) {
    const int c = g + KG_GROUP * k;
    s[k] = c < KM_MC ? nmax(b[k] - dot_row(sh, c, L.x), slack_floor) : 1.0f;
    if (c >= KM_MC) lam[k] = 0.0f;
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const float mu = kdiv(row_dot(s, lam), (float)KM_MC);
    float rp[KG_R];
    float rp_max = 0.0f;
#pragma unroll
    for (int k = 0; k < KG_R; ++k) {
      const int c = g + KG_GROUP * k;
      rp[k] = 0.0f;
      if (c < KM_MC) {
        rp[k] = dot_row(sh, c, L.x) + s[k] - b[k];
        rp_max = nmax(rp_max, fabsf(rp[k]));
      }
    }
    rp_max = gmax(rp_max);
    // r_d = Pr x + q + A^T lam
#pragma unroll
    for (int k = 0; k < KG_R; ++k) {
      const int c = g + KG_GROUP * k;
      if (c < KM_MC) L.vec[c] = lam[k];
    }
    gsync();
    float rd[KG_NO];
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      rd[o] = 0.0f;
      if (i < KM_N) {
        const float atl = dot_col(sh, i, L.vec);
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < KM_N; ++j) acc = fmaf(hdot(L, i, j), L.x[j], acc);
        rd[o] = acc + q[o] + atl;
      }
    }
    gsync();
    const bool active = (mu > km::kMuFloor) || (rp_max > km::kMuFloor);
#pragma unroll
    for (int k = 0; k < KG_R; ++k) {
      const int c = g + KG_GROUP * k;
      if (c < KM_MC) L.vec[c] = nclip(kdiv(lam[k], s[k]), 1e-14f, 1e14f);
    }
    gsync();
    form_newton(sh, L, g);
    chol(L, g);
    float rsl[KG_R], dx[KG_NO], ds[KG_R], dlam[KG_R];
#pragma unroll
    for (int k = 0; k < KG_R; ++k) rsl[k] = s[k] * lam[k];
    direction(sh, L, g, rd, rp, s, lam, rsl, dx, ds, dlam);
    const float alpha_a = nmin(max_step(g, s, ds), max_step(g, lam, dlam));
    float sa[KG_R], la[KG_R];
#pragma unroll
    for (int k = 0; k < KG_R; ++k) {
      sa[k] = s[k] + alpha_a * ds[k];
      la[k] = lam[k] + alpha_a * dlam[k];
    }
    const float mu_aff = kdiv(row_dot(sa, la), (float)KM_MC);
    const float ratio = kdiv(mu_aff, mu + 1e-30f);
    const float sigma = ratio * ratio * ratio;
#pragma unroll
    for (int k = 0; k < KG_R; ++k)
      rsl[k] = s[k] * lam[k] + ds[k] * dlam[k] - sigma * mu;
    // the corrector reuses the predictor's storage
    direction(sh, L, g, rd, rp, s, lam, rsl, dx, ds, dlam);
    // both steps are reduced in every lane: a shuffle under a lane's
    // ``active`` would leave the other groups of its warp behind
    const float alpha_c = nmin(max_step(g, s, ds), max_step(g, lam, dlam));
    const float alpha = active ? alpha_c : 0.0f;
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      if (i < KM_N && isfinite(dx[o])) L.x[i] = L.x[i] + alpha * dx[o];
    }
#pragma unroll
    for (int k = 0; k < KG_R; ++k) {
      if (g + KG_GROUP * k >= KM_MC) continue;
      if (isfinite(ds[k])) s[k] = s[k] + alpha * ds[k];
      if (isfinite(dlam[k])) lam[k] = lam[k] + alpha * dlam[k];
    }
    gsync();
  }
}

// Per-lane operand tiles, lanes-minor in device memory (row r of lane b
// at r * B + b): ``rows`` rows of the block's lanes [b0, b0 + KG_LANES)
// into (or out of) shared memory at base + q * stride + r for block lane
// q, coalesced over the lanes; lanes past the batch read zeros and store
// nothing.
__device__ __forceinline__ void stage_in(float* base, int stride,
                                         const float* src, int rows,
                                         long long b0, long long B, int tid) {
  for (int e = tid; e < rows * KG_LANES; e += KG_THREADS) {
    const int r = e / KG_LANES, q = e % KG_LANES;
    const long long b = b0 + q;
    base[q * stride + r] = b < B ? src[r * B + b] : 0.0f;
  }
}
__device__ __forceinline__ void stage_out(const float* base, int stride,
                                          float* dst, int rows, long long b0,
                                          long long B, int tid) {
  for (int e = tid; e < rows * KG_LANES; e += KG_THREADS) {
    const int r = e / KG_LANES, q = e % KG_LANES;
    const long long b = b0 + q;
    if (b < B) dst[r * B + b] = base[q * stride + r];
  }
}

}  // namespace kg
