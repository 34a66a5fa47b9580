// Batched interior-point QP in least-squares form with lane-shared
// constraint rows: a group of threads per lane (ipm_group.cuh).
//
// Replaces the TPU kernel _ipm_kernel (koopman_realizations_tpu/ops/
// pallas/qp_ipm.py:299, called at :648 by solve_qp_factored_batched) in
// its factored mode with optional warm duals, both A^T D A forms and the
// optional additive linear term q0:
//   min ||W x + v||^2 + x' diag(r) x (+ q0' x)  s.t.  A x <= b
// with W (p, n) and v (p) per lane, r lane-shared, A the row-equilibrated
// rows and b, x0 and the dual start per lane in the same units.  The
// bilinear controller reaches it off the lift-fused route: every pass of
// the unblocked stack (n=27, mc=108 banded; with smoothness rows mc=156
// and a dense A^T D A) and the re-rolled passes of iterated
// relinearization (blocked, n=12, mc=48).  The NMPC's 'linear'
// between-pass update reaches the q0 build (KM_Q0; n=12, mc=48, p=22)
// every SQP pass with its Levenberg term q0 = -2 rho Tb^T U_lin, per lane
// in original units, added to 2 W^T v before the objective scale
// (qp_ipm.py:355-359); builds without KM_Q0 keep their arguments.  The
// wrapper (ops/kernels/ipm_factored.py:solve_qp_factored) equilibrates the
// rows, scales the dual start by them and forms the ok mask and the
// multipliers in original units, as the JAX wrapper does.
//
// Bound on an H100: at n=12 the bytes (W alone is 1 KB of a lane's
// ~2 KB, against ~2.3e4 operations with 4 iterations); at n=27 the
// operations (~1.6e5 with 8 iterations banded, ~3.0e5 with 12 dense, on
// ~4.4-5.2 KB a lane).
//
// Design: a block takes KG_LANES consecutive lanes, a group of KG_GROUP
// threads each (a warp at n=27; at n=12 the size measured fastest,
// ops/kernels/ipm_group.py).  The per-lane operands keep their
// lanes-minor layout, so the block stages them with loads coalesced over
// its lanes: x0, b, the dual start and q0 into shared memory, and W with
// v (n + 1 values a lane a row) in cp.async copies into a ring of two
// slots of half the rows each, both in flight at once, the groups folding
// the first half into the lane's Gram while the second lands -- each
// thread accumulates its share of the packed lower triangle in registers,
// in the row order of the thread-per-lane kernel.  (A ring of one row a
// slot left each block waiting out one memory latency a row: 22 a
// launch.)  The objective scale, the scaled Hessian (into
// shared memory) and the dual start follow, then the cooperative Mehrotra
// loop of ipm_group.cuh; x, s, lam and obj leave through shared memory
// with stores coalesced over the lanes.
#include "ipm_group.cuh"

struct IpmFactoredArgs {
  km::Cons con;
  const float* rdiag;  // (KM_N) input cost
  const float* W;      // (KM_P, KM_N, B)
  const float* v;      // (KM_P, B)
  const float* b;      // (KM_MC, B) b / row
  const float* x0;     // (KM_N, B) primal start
  const float* lam0;   // (KM_MC, B) dual start * row, or null (cold)
  float* x;            // (KM_N, B)
  float* s;            // (KM_MC, B)
  float* lam;          // (KM_MC, B) equilibrated multipliers
  float* obj;          // (B) objective scale
#if defined(KM_Q0) && KM_Q0
  const float* q0;     // (KM_N, B) additive linear term, original units
#endif
  long long B;
  int iters;
  float slack_floor;
};

// W rows [r0, r1) (and v_r) of the block's lanes into their ring slots,
// one commit group: slot r holds [lane][i] with the odd lane stride
// KG_NP, v after the KG_LANES rows.
__device__ __forceinline__ void prefetch_rows(const IpmFactoredArgs& a,
                                              float* ring, int r0, int r1,
                                              long long b0, int tid) {
  for (int e = tid; e < (r1 - r0) * (KM_N + 1) * KG_LANES;
       e += KG_THREADS) {
    const int r = r0 + e / ((KM_N + 1) * KG_LANES);
    const int f = e % ((KM_N + 1) * KG_LANES);
    const int i = f / KG_LANES, q = f % KG_LANES;
    const long long b = b0 + q;
    const bool ok = b < a.B;
    const long long lb = ok ? b : a.B - 1;
    float* dst = ring + r * KG_SLOT;
    if (i < KM_N)
      kg::copy_async(dst + q * KG_NP + i, a.W + (r * KM_N + i) * a.B + lb, ok);
    else
      kg::copy_async(dst + KG_LANES * KG_NP + q, a.v + r * a.B + lb, ok);
  }
  __pipeline_commit();
}

// The Gram terms of W rows [r0, r1) from the ring (row order).
__device__ __forceinline__ void gram_rows(const float* ring, int r0, int r1,
                                          int grp, int g,
                                          const int (&ti)[KG_NT],
                                          const int (&tk)[KG_NT],
                                          float (&P)[KG_NT],
                                          float (&qv)[KG_NO]) {
#pragma unroll 1
  for (int r = r0; r < r1; ++r) {
    const float* w = ring + r * KG_SLOT + grp * KG_NP;
    const float vr = ring[r * KG_SLOT + KG_LANES * KG_NP + grp];
#pragma unroll
    for (int j = 0; j < KG_NT; ++j)
      if (g + KG_GROUP * j < KG_T) P[j] = fmaf(w[ti[j]], w[tk[j]], P[j]);
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      if (i < KM_N) qv[o] = fmaf(w[i], vr, qv[o]);
    }
  }
}

__global__ void KG_BOUNDS
ipm_factored_kernel(const IpmFactoredArgs a) {
  float* sm = kg::dynamic_smem();
  const int tid = threadIdx.x;
  const int grp = tid / KG_GROUP, g = tid % KG_GROUP;
  const long long b0 = (long long)blockIdx.x * KG_LANES;
  const long long B = a.B;
  const kg::Shared sh = kg::shared_view(sm);
  const kg::Lane L = kg::lane_view(sm, grp, grp);
  float* ring = sm + KG_OFF_RING;
  float* lanes = sm + KG_OFF_LANE;
  float* work = sm + KG_OFF_WORK;
  const bool warm = a.lam0 != nullptr;

  kg::load_shared(a.con, sh, tid);
  // W and v in two halves of rows, both in flight at once (the ring lies
  // over the lane and work regions)
  constexpr int kHalf = (KM_P + 1) / 2;
  prefetch_rows(a, ring, 0, kHalf, b0, tid);
  prefetch_rows(a, ring, kHalf, KM_P, b0, tid);
  __syncthreads();

  // the factored Gram P = 2 (sum_r W_r W_r^T + diag(rdiag)), qv =
  // 2 sum_r W_r v_r: thread g holds packed entries t = g + G j
  int ti[KG_NT], tk[KG_NT];
  float P[KG_NT], qv[KG_NO];
#pragma unroll
  for (int j = 0; j < KG_NT; ++j) {
    const int t = g + KG_GROUP * j;
    tk[j] = t < KG_T ? kg::tcol(t) : 0;
    ti[j] = t < KG_T ? tk[j] + t - kg::off(tk[j]) : 0;
    P[j] = (t < KG_T && ti[j] == tk[j]) ? km::ldg(a.rdiag + ti[j]) : 0.0f;
  }
#pragma unroll
  for (int o = 0; o < KG_NO; ++o) qv[o] = 0.0f;
  __pipeline_wait_prior(1);
  __syncthreads();
  gram_rows(ring, 0, kHalf, grp, g, ti, tk, P, qv);
  __pipeline_wait_prior(0);
  __syncthreads();
  gram_rows(ring, kHalf, KM_P, grp, g, ti, tk, P, qv);
  __syncthreads();
  // x0 into x, b into the lane's rest (overwritten by the Hessian after
  // the groups took their rows), the dual start into M, q0 into vec
  kg::stage_in(lanes + KG_L_X, KG_LSTRIDE, a.x0, KM_N, b0, B, tid);
  kg::stage_in(lanes + KG_L_REST, KG_LSTRIDE, a.b, KM_MC, b0, B, tid);
  if (warm) kg::stage_in(work, KG_WSTRIDE, a.lam0, KM_MC, b0, B, tid);
#if defined(KM_Q0) && KM_Q0
  kg::stage_in(work + KG_T + KM_N, KG_WSTRIDE, a.q0, KM_N, b0, B, tid);
#endif
  __syncthreads();

  // the lane's rows and entries from the staged tiles
  float q[KG_NO], rhs[KG_R], s[KG_R], lam[KG_R];
#pragma unroll
  for (int o = 0; o < KG_NO; ++o) {
    q[o] = qv[o] * 2.0f;
#if defined(KM_Q0) && KM_Q0
    const int i = g + KG_GROUP * o;
    if (i < KM_N) q[o] += L.vec[i];
#endif
  }
#pragma unroll
  for (int k = 0; k < KG_R; ++k) {
    const int c = g + KG_GROUP * k;
    rhs[k] = c < KM_MC ? L.Pr[c] : 0.0f;
    lam[k] = (warm && c < KM_MC) ? L.M[c] : 0.0f;
  }
  // the objective scale: max diag(P), the diagonal gathered from its
  // owners in column order
#pragma unroll
  for (int j = 0; j < KG_NT; ++j) P[j] *= 2.0f;
  float obj = 0.0f;
#pragma unroll
  for (int j = 0; j < KM_N; ++j) {
    const int t = kg::off(j);
    const float d = kg::gshfl(P[t / KG_GROUP], t % KG_GROUP);
    obj = j == 0 ? d : km::nmax(obj, d);
  }
  obj = km::nmax(obj, 1e-8f);
  const float iobj = km::kdiv(1.0f, obj);
#pragma unroll
  for (int o = 0; o < KG_NO; ++o) q[o] = q[o] * iobj;
  kg::gsync();
#pragma unroll
  for (int j = 0; j < KG_NT; ++j) {
    const int t = g + KG_GROUP * j;
    if (t < KG_T)
      L.Pr[t] = P[j] * iobj + (ti[j] == tk[j] ? km::kReg : 0.0f);
  }
#pragma unroll
  for (int k = 0; k < KG_R; ++k)
    lam[k] = warm ? km::ksqrt(km::nclip(lam[k] * iobj, 1e-4f, 1e4f)) : 1.0f;
  kg::gsync();

  kg::mehrotra(sh, L, g, a.iters, a.slack_floor, q, rhs, s, lam);

  // s and lam over the Hessian, obj beside x; out coalesced over lanes
#pragma unroll
  for (int k = 0; k < KG_R; ++k) {
    const int c = g + KG_GROUP * k;
    if (c < KM_MC) {
      L.Pr[c] = s[k];
      L.Pr[KM_MC + c] = lam[k];
    }
  }
  if (g == 0) lanes[grp * KG_LSTRIDE + KG_L_OBJ] = obj;
  __syncthreads();
  kg::stage_out(lanes + KG_L_X, KG_LSTRIDE, a.x, KM_N, b0, B, tid);
  kg::stage_out(lanes + KG_L_REST, KG_LSTRIDE, a.s, KM_MC, b0, B, tid);
  kg::stage_out(lanes + KG_L_REST + KM_MC, KG_LSTRIDE, a.lam, KM_MC, b0, B,
                tid);
  kg::stage_out(lanes + KG_L_OBJ, KG_LSTRIDE, a.obj, 1, b0, B, tid);
}

extern "C" int km_ipm_factored(const IpmFactoredArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      ipm_factored_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KG_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((args->B + KG_LANES - 1) / KG_LANES);
  ipm_factored_kernel<<<grid, KG_THREADS, KG_SMEM_BYTES,
                        (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
