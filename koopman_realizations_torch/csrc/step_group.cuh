// The fused step kernels on the skeleton of lane_group.cuh: step_fused.cu
// (the bilinear controller) and linear_step_fused.cu.  Two launches a
// step on the stream:
// - the front launch, a thread per lane (128-thread launch bounds, no cap
//   on its registers): the lane's QP operands (the bilinear lift,
//   assembly, factored Gram and objective scale; the linear gradient)
//   and the plant -- SDIRK2 of the arm on the PREVIOUS input, which does
//   not depend on this step's QP -- with its marker outputs and finite
//   flag, all into the lane's scratch row;
// - the solve launch under the plan's launch bounds: each thread puts its
//   lane's u_prev, x0 and obj into the lane region; the block solves its
//   lanes' QPs a group of KG_GROUP threads a lane (ipm_group.cuh); the
//   group forms the ok mask, the freeze decision and the dual carry; then
//   each thread freezes its lane and advances the rest of the carry (the
//   selections of _plant_freeze_epilogue, koopman_realizations_tpu/ops/
//   pallas/step_fused.py:150).
//
// The front launch writes no carry field: the caller may pass an output
// carry that aliases the input carry (Ksim.fused_runner updates ysc,
// upsc, xpl, x0 and lamc in place), and the solve launch still reads the
// old values to freeze a lane.  Within the solve launch each element is
// read before it is written, by the thread that writes it: the lane's
// thread for ysc, upsc, xpl, x0, yp and alive (after the block's last
// barrier), the row's owner for lamc.
//
// Scratch row: the bilinear step's QP sections (KG_S_PR, KG_S_Q,
// KG_S_OBJ), then [xs: nx][y: ny][fin: 1] from KG_S_PLANT.  Lane region:
// [x: n][obj: 1][u_prev: m][keep: 1].
#pragma once

#include "lane_group.cuh"

#define KG_S_XS KG_S_PLANT                  // scratch: new plant state
#define KG_S_Y (KG_S_PLANT + KM_NX)         // scratch: marker outputs
#define KG_S_FIN (KG_S_Y + KM_NY)           // scratch: 1 finite, 0 not
#define KG_L_KEEP (KG_H_UP + KM_M)          // lane region: 1 keep, 0 freeze

namespace kst {

// The front's plant for lane bl into its scratch row hs: SDIRK2 on the
// previous input (original units), the finite flag, the marker outputs.
__device__ __forceinline__ void plant_front(const km::StepIO& io,
                                            long long bl, long long B,
                                            const float (&up)[KM_M],
                                            float* hs) {
  constexpr float UF[KM_M] = KM_UF;
  constexpr float UO[KM_M] = KM_UO;
  float xs[KM_NX], u[KM_M];
#pragma unroll
  for (int i = 0; i < KM_NX; ++i) xs[i] = io.xpl[i * B + bl];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) u[j] = up[j] * UF[j] + UO[j];
  km::sdirk2(xs, u, io.w[bl], io.w[B + bl]);
  bool fin = true;
#pragma unroll
  for (int i = 0; i < KM_NX; ++i) fin = fin && isfinite(xs[i]);
  float y[KM_NY];
  km::arm_outputs(xs, y);
#pragma unroll
  for (int i = 0; i < KM_NX; ++i) hs[KG_S_XS + i] = xs[i];
#pragma unroll
  for (int j = 0; j < KM_NY; ++j) hs[KG_S_Y + j] = y[j];
  hs[KG_S_FIN] = fin ? 1.0f : 0.0f;
}

// The solve's ok rule (qp_ipm.py:986-995: finite iterate, sane gap and
// primal residual within kTol of the row scale) by the group: the gap as
// one fma chain over the rows in row order (the thread-per-lane order),
// A x - b over each thread's rows (the products skip only A's exact
// zeros), then the group's max; the max of |b| likewise; x from the lane
// region.
__device__ __forceinline__ bool ok_mask(const kg::Shared& sh,
                                        const kg::Lane& L, int g,
                                        const float (&b)[KG_R],
                                        const float (&s)[KG_R],
                                        const float (&lam)[KG_R]) {
  const float gap = km::kdiv(kg::row_dot(s, lam), (float)KM_MC);
  float r_p = 0.0f, bmax = 1.0f;
#pragma unroll
  for (int k = 0; k < KG_R; ++k) {
    const int c = g + KG_GROUP * k;
    if (c < KM_MC) {
      r_p = km::nmax(r_p, kg::dot_row(sh, c, L.x) - b[k]);
      bmax = km::nmax(bmax, fabsf(b[k]));
    }
  }
  r_p = kg::gmax(r_p);
  bmax = kg::gmax(bmax);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < KM_N; ++i) finite = finite && isfinite(L.x[i]);
  return finite && (gap < km::kGapSane) && (r_p < km::kTol * bmax);
}

// What the group does with its lane's solution: the ok mask, the freeze
// decision (alive, ok, finite plant) into the lane region, and the dual
// carry lam * obj (obj from the lane region: the bilinear step's
// objective scale, 1 in the linear step) stored by the rows' owners.
struct StepDone {
  const km::StepIO& io;
  long long B;
  __device__ __forceinline__ void operator()(
      const kg::Shared& sh, const kg::Lane& L, float* H, const float* hs,
      long long b, int g, const float (&rhs)[KG_R], const float (&s)[KG_R],
      const float (&lam)[KG_R]) const {
    const bool ok = ok_mask(sh, L, g, rhs, s, lam);
    const bool keep = (io.alive[b < B ? b : B - 1] > 0.5f) && ok &&
                      (hs[KG_S_FIN] > 0.5f);
    if (g == 0) H[KG_L_KEEP] = keep ? 1.0f : 0.0f;
    if (b >= B) return;
    const float lam_scale = H[KG_L_OBJ];
#pragma unroll
    for (int k = 0; k < KG_R; ++k) {
      const int c = g + KG_GROUP * k;
      if (c < KM_MC)
        io.lamc_o[c * B + b] = keep ? lam[k] * lam_scale : io.lamc[c * B + b];
    }
  }
};

// The lane's thread after the block's solves: the alive freeze and the
// carry advance (u_prev = move 0 of the plan, the next primal start
// Pwarm @ x, the plant's state and outputs), from the lane region H and
// the lane's scratch row hs.
__device__ __forceinline__ void freeze(const km::StepIO& io,
                                       const float* Pwarm, const float* H,
                                       const float* hs, long long b,
                                       long long B) {
  constexpr float YF[KM_NY] = KM_YF;
  constexpr float YO[KM_NY] = KM_YO;
  constexpr int PROJ[KM_NPROJ] = KM_PROJ;
  const bool keep = H[KG_L_KEEP] > 0.5f;
  io.alive_o[b] = keep ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 0; i < KM_NX; ++i)
    io.xpl_o[i * B + b] = keep ? hs[KG_S_XS + i] : io.xpl[i * B + b];
#pragma unroll
  for (int j = 0; j < KM_NY; ++j)
    io.ysc_o[j * B + b] =
        keep ? km::kdiv(hs[KG_S_Y + j] - YO[j], YF[j]) : io.ysc[j * B + b];
#pragma unroll
  for (int j = 0; j < KM_NPROJ; ++j)
    io.yp_o[j * B + b] = keep ? hs[KG_S_Y + PROJ[j]] : io.yp[j * B + b];
#pragma unroll
  for (int j = 0; j < KM_M; ++j)
    io.upsc_o[j * B + b] = keep ? H[KG_L_X + j] : H[KG_H_UP + j];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < KM_N; ++j)
      acc = fmaf(km::ldg(Pwarm + i * KM_N + j), H[KG_L_X + j], acc);
    io.x0_o[i * B + b] = keep ? acc : io.x0[i * B + b];
  }
}

// The solve launch's lanes of a step kernel: Args has io, Pwarm, scratch,
// B and iters; the Hessian, gradient and dual sources are the build's;
// cFr, F0r the right-hand side's operands.
template <class Args, class Hess, class Grad, class Duals>
struct StepLanes {
  const Args& a;
  const float* cFr;
  const float* F0r;
  Hess hess;
  Grad grad;
  Duals duals;
  __device__ __forceinline__ void load(float* sm, float* H, long long bl,
                                       int tid) const {
    hess.load(sm, tid);
    const long long B = a.B;
#pragma unroll
    for (int j = 0; j < KM_M; ++j) H[KG_H_UP + j] = a.io.upsc[j * B + bl];
#pragma unroll
    for (int i = 0; i < KM_N; ++i) H[KG_L_X + i] = a.io.x0[i * B + bl];
#ifdef KG_S_OBJ
    H[KG_L_OBJ] = kl::scratch_row(a.scratch, bl)[KG_S_OBJ];
#else
    H[KG_L_OBJ] = 1.0f;
#endif
  }
  __device__ __forceinline__ void solve(const kg::Shared& sh, float* sm,
                                        int ql, int grp, int g) const {
    kl::solve_lane(a, cFr, F0r, sh, sm, ql, grp, g, 1e-2f, hess, grad, duals,
                   StepDone{a.io, a.B});
  }
  __device__ __forceinline__ void store(const float* H, long long b) const {
    freeze(a.io, a.Pwarm, H, kl::scratch_row(a.scratch, b), b, a.B);
  }
};

}  // namespace kst
