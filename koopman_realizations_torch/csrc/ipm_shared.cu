// Batched interior-point QP with a lane-shared Hessian and lane-shared
// constraint rows: one CUDA thread per lane.
//
// Replaces the TPU kernel _ipm_kernel (koopman_realizations_tpu/ops/
// pallas/qp_ipm.py:299, called at :529 by solve_qp_shared_batched) in its
// lane-shared-P mode (shared_P=True, banded A^T D A, cold duals), the mode
// the linear controller's general runner reaches:
//   min 1/2 x' Psh x + q' x  s.t.  A x <= b
// with Psh (n, n) the host-equilibrated Hessian P / obj, A the
// row-equilibrated constraints, q and b per lane in the same units, the
// primal start x0 per lane and lam = 1.  The wrapper
// (ops/kernels/ipm_shared.py:solve_qp_shared) does the equilibration, the
// ok mask and the multipliers' return to original units, as the JAX
// wrapper does.  The factored mode is ipm_factored.cu; the per-lane-P
// mode of the TPU kernel is not ported.
//
// Bound on an H100: compute.  At the linear controller's shape (n=12,
// mc=48, band 3, 6 iterations) a lane needs ~3e4 operations on 0.7 KB of
// lane input and output, so the f32 rate, not the memory, sets the
// floor.  The design is the Mehrotra loop of kmpc_device.cuh that the
// bilinear kernels run, reading the Hessian through the lane-shared
// accessor: per-lane iterates in registers or thread-local memory, the
// shared Hessian and constraint tables as warp-uniform broadcasts through
// the read-only cache, lanes-minor coalesced loads and stores.
#include "kmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
#endif

struct IpmSharedArgs {
  km::Cons con;
  const float* Psh;    // (KM_N, KM_N) P / obj
  const float* q;      // (KM_N, B) q / obj
  const float* b;      // (KM_MC, B) b / row
  const float* x0;     // (KM_N, B) primal start
  float* x;            // (KM_N, B)
  float* s;            // (KM_MC, B)
  float* lam;          // (KM_MC, B) equilibrated multipliers
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
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
    rhs[c] = a.b[c * B + b];
    lam[c] = 1.0f;
  }
  km::mehrotra(a.con, a.iters, a.slack_floor, km::SharedHessian{a.Psh}, q,
               rhs, x, s, lam);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = x[i];
#pragma unroll
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
