// Batched small-SPD solve x = M^-1 b by Cholesky: one CUDA thread per
// system.
//
// Replaces the TPU kernel _chol_solve_kernel (koopman_realizations_tpu/
// ops/pallas/batch_chol.py:28, called at :83 by solve_spd_pallas), the
// ops layer's public batched SPD solve: M (B, n, n) and b (B, n) in, x
// (B, n) out, f32.  The arithmetic is the TPU kernel's: per column an
// exact square root and one IEEE reciprocal, the column scaled by it and
// a rank-1 downdate of the rest (only the lower triangle is read and
// formed; the TPU kernel's full-width columns agree on it), no added
// regularization; then forward substitution L y = b and backward
// substitution L^T x = y, each row's sum subtracted in ascending column
// order and divided by the diagonal (IEEE divides).  The interior point's
// chol_solve (kmpc_device.cuh) runs its backward substitution by columns
// in descending order, so this solve is its own.  n is the compile-time
// KM_N, one build per n.
//
// Bound on an H100: at the shapes chip_smoke.py runs (n=12 and n=27,
// B=65536) ~n^3/3 operations a system on 4 n (n + 2) bytes: ~1.4 and
// ~2.7 operations a byte, under the card's ~20 f32 operations a byte, so
// the bytes, if the loads were coalesced.  This first design reads each
// system's lower triangle straight from its batch-major rows (a warp's 32
// loads fall in 32 different systems; the sectors they share with the
// next rows are reused through L1) and holds the factor in registers
// (n=12) or thread-local memory (n=27).  Staging a warp's systems through
// shared memory for coalesced loads is the redesign for this card.
#include <cuda_runtime.h>
#include <math.h>

#ifndef KM_N
#error "batch_chol.cu needs the generated configuration header"
#endif
#ifndef KM_THREADS
#define KM_THREADS 128
#endif

struct BatchCholArgs {
  const float* M;      // (B, KM_N, KM_N) SPD systems
  const float* b;      // (B, KM_N) right-hand sides
  float* x;            // (B, KM_N) solutions
  long long B;
};

__global__ void __launch_bounds__(KM_THREADS)
batch_chol_kernel(const BatchCholArgs a) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const float* M = a.M + lane * (KM_N * KM_N);
  float L[KM_N][KM_N];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
#pragma unroll
    for (int k = 0; k <= i; ++k) L[i][k] = M[i * KM_N + k];
  }
  // factor in place: column j scaled by 1 / sqrt of its pivot, then the
  // rank-1 downdate of the trailing lower triangle
#pragma unroll
  for (int j = 0; j < KM_N; ++j) {
    const float d = __fdiv_rn(1.0f, __fsqrt_rn(L[j][j]));
#pragma unroll
    for (int i = j; i < KM_N; ++i) L[i][j] = L[i][j] * d;
#pragma unroll
    for (int i = j + 1; i < KM_N; ++i) {
#pragma unroll
      for (int k = j + 1; k <= i; ++k) L[i][k] -= L[i][j] * L[k][j];
    }
  }
  float r[KM_N];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {          // L y = b
    float acc = a.b[lane * KM_N + i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= L[i][k] * r[k];
    r[i] = __fdiv_rn(acc, L[i][i]);
  }
#pragma unroll
  for (int i = KM_N - 1; i >= 0; --i) {     // L^T x = y
    float acc = r[i];
#pragma unroll
    for (int k = i + 1; k < KM_N; ++k) acc -= L[k][i] * r[k];
    r[i] = __fdiv_rn(acc, L[i][i]);
  }
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[lane * KM_N + i] = r[i];
}

extern "C" int km_batch_chol(const BatchCholArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  batch_chol_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
