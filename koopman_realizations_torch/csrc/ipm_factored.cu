// Batched interior-point QP in least-squares form with lane-shared
// constraint rows: one CUDA thread per lane.
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
// (qp_ipm.py:355-359); builds without KM_Q0 keep their arguments and
// code.  The wrapper (ops/kernels/ipm_factored.py:solve_qp_factored)
// equilibrates the rows, scales the dual start by them and forms the ok
// mask and the multipliers in original units, as the JAX wrapper does.
// There are no padding lanes: the ragged last block masks its threads.
//
// Bound on an H100: at n=12 the bytes (W alone is 1 KB of a lane's
// ~2 KB, against ~2.3e4 operations with 4 iterations); at n=27 the
// operations (~1.6e5 with 8 iterations banded, ~3.0e5 with 12 dense, on
// ~4.4-5.2 KB a lane).
// The design streams W one row at a time from device memory into the
// lower-triangle Gram (km::factored_gram through km::LaneRows, as the
// assembly kernels stream their generated rows), then runs the shared
// factored tail and Mehrotra loop of kmpc_device.cuh.  At n=27 a thread
// holds the Hessian, M and L (3 x 729 floats) in thread-local memory, and
// the loops over the constraint rows stay rolled (KM_ROLL, see
// kmpc_device.cuh); this build is expected far from its bound.  A warp or
// a block per lane group with the factor in shared memory is the
// redesign for this card.
#include "kmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
#endif

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

__global__ void __launch_bounds__(KM_THREADS)
ipm_factored_kernel(const IpmFactoredArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long B = a.B;
  float Pr[KM_N][KM_N], q[KM_N];
  km::factored_gram(a.rdiag, km::LaneRows{a.W + b, a.v + b, B}, Pr, q);
#if defined(KM_Q0) && KM_Q0
#pragma unroll
  for (int i = 0; i < KM_N; ++i) q[i] += a.q0[i * B + b];
#endif
  float rhs[KM_MC], x[KM_N], s[KM_MC], lam[KM_MC];
  const bool warm = a.lam0 != nullptr;
#pragma unroll
  for (int i = 0; i < KM_N; ++i) x[i] = a.x0[i * B + b];
  KM_ROWS
  for (int c = 0; c < KM_MC; ++c) {
    rhs[c] = a.b[c * B + b];
    lam[c] = warm ? a.lam0[c * B + b] : 1.0f;
  }
  const float obj = km::solve_factored(a.con, a.iters, a.slack_floor, warm,
                                       Pr, q, rhs, x, s, lam);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = x[i];
  KM_ROWS
  for (int c = 0; c < KM_MC; ++c) {
    a.s[c * B + b] = s[c];
    a.lam[c * B + b] = lam[c];
  }
  a.obj[b] = obj;
}

extern "C" int km_ipm_factored(const IpmFactoredArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  ipm_factored_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
