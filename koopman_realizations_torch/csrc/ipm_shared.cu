// Batched interior-point QP with a lane-shared or per-lane Hessian and
// lane-shared constraint rows: one CUDA thread per lane.
//
// Replaces the TPU kernel _ipm_kernel (koopman_realizations_tpu/ops/
// pallas/qp_ipm.py:299, called at :529 by solve_qp_shared_batched) in
// its two dense-objective modes, one build each:
// - lane-shared P (shared_P=True, :368-374; banded A^T D A, cold duals),
//   the mode the linear controller's general runner reaches:
//     min 1/2 x' Psh x + q' x  s.t.  A x <= b
//   with Psh (n, n) the host-equilibrated Hessian P / obj;
// - per-lane P (KM_LANE_P, shared_P=False, :375-379; banded or dense
//   A^T D A, cold or warm duals), reached through ops/qp.py:solve_qp with
//   a batched Hessian (the JAX _pallas_routed_solver's shared_P=not Pb):
//   each lane loads its own P (n, n) and scales it in-kernel as
//   P * iobj + reg I with its objective scale iobj = 1 / max |P| from the
//   host; warm duals arrive scaled by row * iobj (:476-479) and start as
//   sqrt(clip(lam0, 1e-4, 1e4)).
// A is the row-equilibrated constraints, q and b per lane in the same
// units (q scaled by iobj on the host), the primal start x0 per lane.
// The wrapper (ops/kernels/ipm_shared.py:solve_qp_shared) does the
// equilibration, the ok mask and the multipliers' return to original
// units, as the JAX wrapper does.  The factored mode is ipm_factored.cu.
// There are no padding lanes (the JAX wrapper's P = I lanes, :496-500):
// the ragged last block masks its threads.
//
// Bound on an H100: compute.  At the linear controller's shape (n=12,
// mc=48, band 3, 6 iterations) a lane needs ~3e4 operations on 0.7 KB of
// lane input and output, so the f32 rate, not the memory, sets the
// floor; the per-lane P adds n*n floats (0.6 KB at n=12) a lane.  The
// design is the Mehrotra loop of kmpc_device.cuh that the bilinear
// kernels run, reading the Hessian through the lane-shared accessor
// (SharedHessian: warp-uniform broadcasts through the read-only cache)
// or, per lane, through LaneHessian from the lane's scaled copy in
// registers or thread-local memory; per-lane iterates likewise,
// lanes-minor coalesced loads and stores.
#include "kmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
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
#endif
  long long B;
  int iters;
  float slack_floor;
};

__global__ void __launch_bounds__(KM_THREADS)
ipm_shared_kernel(const IpmSharedArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long B = a.B;
  float q[KM_N], rhs[KM_MC], x[KM_N], s[KM_MC], lam[KM_MC];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    q[i] = a.q[i * B + b];
    x[i] = a.x0[i * B + b];
  }
#if defined(KM_LANE_P) && KM_LANE_P
  const bool warm = a.lam0 != nullptr;
  KM_ROWS
  for (int c = 0; c < KM_MC; ++c) {
    rhs[c] = a.b[c * B + b];
    lam[c] = warm ? km::ksqrt(km::nclip(a.lam0[c * B + b], 1e-4f, 1e4f))
                  : 1.0f;
  }
  const float iobj = a.iobj[b];
  float Pr[KM_N][KM_N];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
#pragma unroll
    for (int j = 0; j < KM_N; ++j)
      Pr[i][j] = a.Psh[(i * KM_N + j) * B + b] * iobj
                 + (i == j ? km::kReg : 0.0f);
  }
  km::mehrotra(a.con, a.iters, a.slack_floor, km::LaneHessian{Pr}, q, rhs,
               x, s, lam);
#else
  KM_ROWS
  for (int c = 0; c < KM_MC; ++c) {
    rhs[c] = a.b[c * B + b];
    lam[c] = 1.0f;
  }
  km::mehrotra(a.con, a.iters, a.slack_floor, km::SharedHessian{a.Psh}, q,
               rhs, x, s, lam);
#endif
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = x[i];
  KM_ROWS
  for (int c = 0; c < KM_MC; ++c) {
    a.s[c * B + b] = s[c];
    a.lam[c * B + b] = lam[c];
  }
}

extern "C" int km_ipm_shared(const IpmSharedArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  ipm_shared_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
