// Device functions shared by the two CUDA kernels of the bilinear Koopman
// MPC closed loop (bilin_lift.cu, step_fused.cu): the poly lift and QP
// assembly, the factored Gram, the objective scale, the banded A^T D A,
// the Cholesky factor and solve, the Mehrotra predictor-corrector, the ok
// mask, the arm's closed-form right-hand side with dual numbers, SDIRK2
// and the marker kinematics.
//
// They replace the shared Pallas device functions of the JAX package
// (ops/pallas/qp_ipm.py:143-296 and :686-769, models/arm_lanes.py
// sdirk2_rows), one CUDA thread per scenario lane.  Per-lane operands are
// lanes-minor (row r of lane b at r * B + b), so every per-lane load and
// store of a warp is coalesced; lane-shared operands are read through the
// read-only cache, where a warp's identical addresses are one broadcast.
//
// The dimensions, the monomial recurrence and the plant constants are
// compile-time constants of one configuration: the build generates a
// header with them (ops/kernels/_build.py), so every per-lane array has a
// static size and static indices after unrolling.
//
// Numerics follow the JAX kernels: f32 throughout, IEEE-rounded divides
// and square roots (never an approximate reciprocal square root: it kills
// isolated lanes), NaN-propagating min/max/clip as in XLA.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef KM_N
#error "kmpc_device.cuh needs the generated configuration header"
#endif
#if KM_BAND < 0
#error "the kernels form A^T D A from the banded tables only"
#endif

#define KM_PN (KM_P * KM_N)           // W rows of the generator stack
#define KM_MP (KM_M * KM_P)           // CB0 rows
#define KM_NF (KM_NZ + KM_NMONO)      // features [zeta; monomials]

namespace km {

constexpr float kReg = 1e-7f;         // primal regularization (scaled)
constexpr float kMuFloor = 1e-8f;     // converged-lane freeze
constexpr float kTol = 3e-3f;         // ok: primal residual tolerance
constexpr float kGapSane = 5e-2f;     // ok: complementarity gap bound

// Lane-shared operands of the lift-fused QP (ops/qp.py:LiftQP).
struct QP {
  const float* gens;    // (KM_PN + KM_MP + KM_P, KM_NCP) generator stack
  const float* rdiag;   // (KM_N) blocked input cost
  const float* A;       // (KM_MC, KM_N) row-equilibrated constraints
  const float* cFr;     // (KM_MC)
  const float* F0r;     // (KM_MC, KM_M)
  const float* Wd;      // (KM_N, KM_MC) diagonal A^T D A table
  const float* Wo;      // (KM_NWO, KM_MC) off-band A^T D A table
};

__device__ __forceinline__ float kdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float ksqrt(float a) { return __fsqrt_rn(a); }
// XLA's max/min propagate NaN; fmaxf/fminf drop it.
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float nclip(float a, float lo, float hi) {
  return nmin(nmax(a, lo), hi);
}
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }

// ------------------------------------------------------------- lift + QP

// f = [zeta; monomials; 1; 0-pad] for the generator columns.
__device__ __forceinline__ void lift_features(const float (&zeta)[KM_NZ],
                                              float (&f)[KM_NCP]) {
#pragma unroll
  for (int i = 0; i < KM_NZ; ++i) f[i] = zeta[i];
  KM_LIFT_FEATURES(f);
  f[KM_NF] = 1.0f;
#pragma unroll
  for (int i = KM_NF + 1; i < KM_NCP; ++i) f[i] = 0.0f;
}

// One generator row against the features (16-byte broadcast loads).
__device__ __forceinline__ float gen_row(const float* __restrict__ g,
                                         const float (&f)[KM_NCP]) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < KM_NCP / 4; ++c) {
    const float4 w = __ldg(g4 + c);
    acc = fmaf(w.x, f[4 * c], acc);
    acc = fmaf(w.y, f[4 * c + 1], acc);
    acc = fmaf(w.z, f[4 * c + 2], acc);
    acc = fmaf(w.w, f[4 * c + 3], acc);
  }
  return acc;
}

// Lift, assembly and factored Gram (qp_ipm.py:727-769), streaming W: v is
// formed first, then each W row is formed, accumulated into P and qv, and
// dropped -- the per-lane (p*n) W block never exists.
//   P = 2 (sum_r W_r W_r^T + diag(rdiag)),  qv = 2 sum_r W_r v_r
//   v = Pgen f - sqYr + CB0 u_prev,  b = cFr - F0r u_prev
__device__ __forceinline__ void assemble(const QP& qp,
                                         const float (&zeta)[KM_NZ],
                                         const float (&up)[KM_M],
                                         const float* sqYr, long long sq_step,
                                         float (&P)[KM_N][KM_N],
                                         float (&qv)[KM_N],
                                         float (&b)[KM_MC]) {
  float f[KM_NCP];
  lift_features(zeta, f);
  const float* gW = qp.gens;
  const float* gH = qp.gens + (long long)KM_PN * KM_NCP;
  const float* gP = gH + (long long)KM_MP * KM_NCP;
  // row loops stay rolled (the unrolled assembly would not fit the
  // instruction cache); v lives in local memory
  float v[KM_P];
#pragma unroll 1
  for (int r = 0; r < KM_P; ++r)
    v[r] = gen_row(gP + r * KM_NCP, f) - sqYr[r * sq_step];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) {
#pragma unroll 1
    for (int r = 0; r < KM_P; ++r)
      v[r] = fmaf(gen_row(gH + (j * KM_P + r) * KM_NCP, f), up[j], v[r]);
  }
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    qv[i] = 0.0f;
#pragma unroll
    for (int k = 0; k <= i; ++k) P[i][k] = 0.0f;
    P[i][i] = ldg(qp.rdiag + i);
  }
#pragma unroll 1
  for (int r = 0; r < KM_P; ++r) {
    float w[KM_N];
#pragma unroll
    for (int i = 0; i < KM_N; ++i)
      w[i] = gen_row(gW + (r * KM_N + i) * KM_NCP, f);
    const float vr = v[r];
#pragma unroll
    for (int i = 0; i < KM_N; ++i) {
      qv[i] = fmaf(w[i], vr, qv[i]);
#pragma unroll
      for (int k = 0; k <= i; ++k) P[i][k] = fmaf(w[i], w[k], P[i][k]);
    }
  }
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    qv[i] *= 2.0f;
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      P[i][k] *= 2.0f;
      P[k][i] = P[i][k];
    }
  }
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
    float bc = ldg(qp.cFr + c);
#pragma unroll
    for (int j = 0; j < KM_M; ++j)
      bc = bc - ldg(qp.F0r + c * KM_M + j) * up[j];
    b[c] = bc;
  }
}

// Per-lane objective scale: max |P| is the max diagonal of the PSD Gram.
__device__ __forceinline__ float diag_obj_scale(const float (&P)[KM_N][KM_N]) {
  float obj = P[0][0];
#pragma unroll
  for (int j = 1; j < KM_N; ++j) obj = nmax(obj, P[j][j]);
  return nmax(obj, 1e-8f);
}

// y = A x (mc rows) and y = A^T v (n rows) against the shared A.
__device__ __forceinline__ void matvec_A(const float* __restrict__ A,
                                         const float (&x)[KM_N],
                                         float (&y)[KM_MC]) {
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < KM_N; ++i) acc = fmaf(ldg(A + c * KM_N + i), x[i], acc);
    y[c] = acc;
  }
}
__device__ __forceinline__ void matvec_At(const float* __restrict__ A,
                                          const float (&v)[KM_MC],
                                          float (&y)[KM_N]) {
#pragma unroll
  for (int i = 0; i < KM_N; ++i) y[i] = 0.0f;
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
#pragma unroll
    for (int i = 0; i < KM_N; ++i) y[i] = fmaf(ldg(A + c * KM_N + i), v[c], y[i]);
  }
}

// M = Pr + A^T diag(D) A, lower triangle, banded (qp_ipm.py:209-233):
// the diagonal from Wd, the one off-diagonal at KM_BAND from Wo.
__device__ __forceinline__ void form_newton(const QP& qp,
                                            const float (&Pr)[KM_N][KM_N],
                                            const float (&D)[KM_MC],
                                            float (&M)[KM_N][KM_N]) {
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
#pragma unroll
    for (int k = 0; k <= i; ++k) M[i][k] = Pr[i][k];
  }
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    float dg = 0.0f;
#pragma unroll
    for (int c = 0; c < KM_MC; ++c) dg = fmaf(ldg(qp.Wd + i * KM_MC + c), D[c], dg);
    M[i][i] += dg;
  }
#if KM_BAND > 0
#pragma unroll
  for (int i = 0; i < KM_N - KM_BAND; ++i) {
    float og = 0.0f;
#pragma unroll
    for (int c = 0; c < KM_MC; ++c) og = fmaf(ldg(qp.Wo + i * KM_MC + c), D[c], og);
    M[i + KM_BAND][i] += og;
  }
#endif
}

// Lower Cholesky, one IEEE reciprocal of an exact sqrt per column
// (qp_ipm.py:143-176; L[j][j] = M[j][j] / sqrt(M[j][j]) as there).
__device__ __forceinline__ void chol(float (&M)[KM_N][KM_N],
                                     float (&L)[KM_N][KM_N]) {
#pragma unroll
  for (int j = 0; j < KM_N; ++j) {
    const float rd = kdiv(1.0f, ksqrt(M[j][j]));
#pragma unroll
    for (int i = j; i < KM_N; ++i) L[i][j] = M[i][j] * rd;
#pragma unroll
    for (int i = j + 1; i < KM_N; ++i) {
#pragma unroll
      for (int k = j + 1; k <= i; ++k) M[i][k] -= L[i][j] * L[k][j];
    }
  }
}

// Solve L L^T x = rhs (qp_ipm.py:179-206), IEEE divides by the diagonal.
__device__ __forceinline__ void chol_solve(const float (&L)[KM_N][KM_N],
                                           float (&r)[KM_N]) {
#pragma unroll
  for (int k = 0; k < KM_N; ++k) {
    r[k] = kdiv(r[k], L[k][k]);
#pragma unroll
    for (int i = k + 1; i < KM_N; ++i) r[i] -= L[i][k] * r[k];
  }
#pragma unroll
  for (int i = KM_N - 1; i >= 0; --i) {
    r[i] = kdiv(r[i], L[i][i]);
#pragma unroll
    for (int j = 0; j < i; ++j) r[j] -= L[i][j] * r[i];
  }
}

// Largest alpha in (0, 1] keeping v + alpha dv >= 0.01 v (NaN propagates).
__device__ __forceinline__ float max_step(const float (&v)[KM_MC],
                                          const float (&dv)[KM_MC]) {
  float mn = INFINITY;
#pragma unroll
  for (int c = 0; c < KM_MC; ++c)
    if (dv[c] < 0.0f) mn = nmin(mn, kdiv(-v[c], dv[c]));
  return nmin(1.0f, 0.99f * mn);
}

// One Newton direction for the complementarity residual r_slam.
__device__ __forceinline__ void direction(const QP& qp,
                                          const float (&L)[KM_N][KM_N],
                                          const float (&r_d)[KM_N],
                                          const float (&r_p)[KM_MC],
                                          const float (&s)[KM_MC],
                                          const float (&lam)[KM_MC],
                                          const float (&r_slam)[KM_MC],
                                          float (&dx)[KM_N],
                                          float (&ds)[KM_MC],
                                          float (&dlam)[KM_MC]) {
  float t[KM_MC];
#pragma unroll
  for (int c = 0; c < KM_MC; ++c)
    t[c] = kdiv(-r_slam[c] + lam[c] * r_p[c], s[c]);
  float At_t[KM_N];
  matvec_At(qp.A, t, At_t);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) dx[i] = -r_d[i] - At_t[i];
  chol_solve(L, dx);
  float Adx[KM_MC];
  matvec_A(qp.A, dx, Adx);
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
    ds[c] = -r_p[c] - Adx[c];
    dlam[c] = kdiv(-r_slam[c] - lam[c] * ds[c], s[c]);
  }
}

// Fixed-iteration Mehrotra predictor-corrector (qp_ipm.py:236-296): x/lam
// hold the starts on entry (lam already damped), s is formed here.
__device__ __forceinline__ void mehrotra(const QP& qp, int iters,
                                         float slack_floor,
                                         const float (&Pr)[KM_N][KM_N],
                                         const float (&q)[KM_N],
                                         const float (&b)[KM_MC],
                                         float (&x)[KM_N],
                                         float (&s)[KM_MC],
                                         float (&lam)[KM_MC]) {
  {
    float Ax[KM_MC];
    matvec_A(qp.A, x, Ax);
#pragma unroll
    for (int c = 0; c < KM_MC; ++c) s[c] = nmax(b[c] - Ax[c], slack_floor);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float mu = 0.0f;
#pragma unroll
    for (int c = 0; c < KM_MC; ++c) mu = fmaf(s[c], lam[c], mu);
    mu = kdiv(mu, (float)KM_MC);
    float r_p[KM_MC];
    matvec_A(qp.A, x, r_p);
    float rp_max = 0.0f;
#pragma unroll
    for (int c = 0; c < KM_MC; ++c) {
      r_p[c] = r_p[c] + s[c] - b[c];
      rp_max = nmax(rp_max, fabsf(r_p[c]));
    }
    float r_d[KM_N];
    matvec_At(qp.A, lam, r_d);
#pragma unroll
    for (int i = 0; i < KM_N; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < KM_N; ++j) acc = fmaf(Pr[i][j], x[j], acc);
      r_d[i] = acc + q[i] + r_d[i];
    }
    const bool active = (mu > kMuFloor) || (rp_max > kMuFloor);

    float L[KM_N][KM_N];
    {
      float D[KM_MC];
#pragma unroll
      for (int c = 0; c < KM_MC; ++c) D[c] = nclip(kdiv(lam[c], s[c]), 1e-14f, 1e14f);
      float M[KM_N][KM_N];
      form_newton(qp, Pr, D, M);
      chol(M, L);
    }
    float r_slam[KM_MC], dx_a[KM_N], ds_a[KM_MC], dlam_a[KM_MC];
#pragma unroll
    for (int c = 0; c < KM_MC; ++c) r_slam[c] = s[c] * lam[c];
    direction(qp, L, r_d, r_p, s, lam, r_slam, dx_a, ds_a, dlam_a);
    const float alpha_a = nmin(max_step(s, ds_a), max_step(lam, dlam_a));
    float mu_aff = 0.0f;
#pragma unroll
    for (int c = 0; c < KM_MC; ++c)
      mu_aff = fmaf(s[c] + alpha_a * ds_a[c], lam[c] + alpha_a * dlam_a[c], mu_aff);
    mu_aff = kdiv(mu_aff, (float)KM_MC);
    const float ratio = kdiv(mu_aff, mu + 1e-30f);
    const float sigma = ratio * ratio * ratio;
#pragma unroll
    for (int c = 0; c < KM_MC; ++c)
      r_slam[c] = s[c] * lam[c] + ds_a[c] * dlam_a[c] - sigma * mu;
    // the corrector reuses the predictor's storage
    direction(qp, L, r_d, r_p, s, lam, r_slam, dx_a, ds_a, dlam_a);
    const float alpha = active ? nmin(max_step(s, ds_a), max_step(lam, dlam_a)) : 0.0f;
#pragma unroll
    for (int i = 0; i < KM_N; ++i)
      if (isfinite(dx_a[i])) x[i] = x[i] + alpha * dx_a[i];
#pragma unroll
    for (int c = 0; c < KM_MC; ++c) {
      if (isfinite(ds_a[c])) s[c] = s[c] + alpha * ds_a[c];
      if (isfinite(dlam_a[c])) lam[c] = lam[c] + alpha * dlam_a[c];
    }
  }
}

// Lift + assembly + Gram + obj scale + Mehrotra: the QP half of both
// kernels.  lam holds the dual start in row-equilibrated * obj units on
// entry (ignored when cold) and the equilibrated duals on exit; returns
// obj and b for the caller's epilogue.
__device__ __forceinline__ float solve_qp(const QP& qp, int iters,
                                          float slack_floor, bool warm_dual,
                                          const float (&zeta)[KM_NZ],
                                          const float (&up)[KM_M],
                                          const float* sqYr, long long sq_step,
                                          float (&x)[KM_N], float (&s)[KM_MC],
                                          float (&lam)[KM_MC],
                                          float (&b)[KM_MC]) {
  float Pr[KM_N][KM_N], q[KM_N];
  assemble(qp, zeta, up, sqYr, sq_step, Pr, q, b);
  const float obj = diag_obj_scale(Pr);
  const float iobj = kdiv(1.0f, obj);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    q[i] = q[i] * iobj;
#pragma unroll
    for (int j = 0; j < KM_N; ++j) Pr[i][j] = Pr[i][j] * iobj + (i == j ? kReg : 0.0f);
  }
#pragma unroll
  for (int c = 0; c < KM_MC; ++c)
    lam[c] = warm_dual ? ksqrt(nclip(lam[c] * iobj, 1e-4f, 1e4f)) : 1.0f;
  mehrotra(qp, iters, slack_floor, Pr, q, b, x, s, lam);
  return obj;
}

// The solve's ok rule (qp_ipm.py:986-995): finite iterate, sane gap and
// primal residual within kTol of the row scale.
__device__ __forceinline__ bool ok_mask(const QP& qp,
                                        const float (&b)[KM_MC],
                                        const float (&x)[KM_N],
                                        const float (&s)[KM_MC],
                                        const float (&lam)[KM_MC]) {
  float gap = 0.0f;
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) gap = fmaf(s[c], lam[c], gap);
  gap = kdiv(gap, (float)KM_MC);
  float Ax[KM_MC];
  matvec_A(qp.A, x, Ax);
  float r_p = 0.0f, bmax = 1.0f;
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
    r_p = nmax(r_p, Ax[c] - b[c]);
    bmax = nmax(bmax, fabsf(b[c]));
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < KM_N; ++i) finite = finite && isfinite(x[i]);
  return finite && (gap < kGapSane) && (r_p < kTol * bmax);
}


// ----------------------------------------------------------------- plant
// Arm plant (models/arm_lanes.py): only in builds whose configuration
// header carries the plant constants (the step kernel's).
#ifdef KM_NL

#define KM_NX (2 * KM_NL)

// Forward-mode dual number with one tangent per state component: one
// pass of the right-hand side over duals seeded with the unit basis gives
// the Jacobian's columns (the JAX code takes n jax.jvp passes; the
// derivative rules below are jax's, so the two agree to rounding).
struct Dual {
  float v;
  float d[KM_NX];
};

template <class T> __device__ __forceinline__ T constant(float v);
template <> __device__ __forceinline__ float constant<float>(float v) { return v; }
template <> __device__ __forceinline__ Dual constant<Dual>(float v) {
  Dual r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = 0.0f;
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator+(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v + b;
  return r;
}
__device__ __forceinline__ Dual operator+(float a, const Dual& b) { return b + a; }
__device__ __forceinline__ Dual operator-(const Dual& a) {
  Dual r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = -a.d[k];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v - b;
  return r;
}
__device__ __forceinline__ Dual operator-(float a, const Dual& b) {
  Dual r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = -b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, float b) {
  Dual r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = a.d[k] * b;
  return r;
}
__device__ __forceinline__ Dual operator*(float a, const Dual& b) { return b * a; }
// quotient: dx / y + (-dy * x) * y^-2
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = kdiv(a.v, b.v);
  const float inv2 = kdiv(1.0f, b.v * b.v);
#pragma unroll
  for (int k = 0; k < KM_NX; ++k)
    r.d[k] = kdiv(a.d[k], b.v) + (-b.d[k] * a.v) * inv2;
  return r;
}
__device__ __forceinline__ Dual operator/(const Dual& a, float b) {
  Dual r;
  r.v = kdiv(a.v, b);
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = kdiv(a.d[k], b);
  return r;
}
__device__ __forceinline__ float tdiv(float a, float b) { return kdiv(a, b); }
__device__ __forceinline__ Dual tdiv(const Dual& a, const Dual& b) { return a / b; }
__device__ __forceinline__ float tsin(float a) { return sinf(a); }
__device__ __forceinline__ float tcos(float a) { return cosf(a); }
__device__ __forceinline__ float tsqrt(float a) { return ksqrt(a); }
__device__ __forceinline__ Dual tsin(const Dual& a) {
  Dual r;
  r.v = sinf(a.v);
  const float c = cosf(a.v);
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = a.d[k] * c;
  return r;
}
__device__ __forceinline__ Dual tcos(const Dual& a) {
  Dual r;
  r.v = cosf(a.v);
  const float s = sinf(a.v);
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = -(a.d[k] * s);
  return r;
}
__device__ __forceinline__ Dual tsqrt(const Dual& a) {
  Dual r;
  r.v = ksqrt(a.v);
  const float h = kdiv(0.5f, r.v);
#pragma unroll
  for (int k = 0; k < KM_NX; ++k) r.d[k] = a.d[k] * h;
  return r;
}

// Cholesky solve of the small SPD system L L^T x = rhs (chol_soa /
// chol_solve_soa of models/arm_lanes.py, row-oriented).
template <class T, int NN>
__device__ __forceinline__ void chol_soa(const T (&M)[NN][NN], T (&L)[NN][NN]) {
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    T s = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const T d = tsqrt(s);
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < NN; ++i) {
      T t = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = tdiv(t, d);
    }
  }
}
template <class T, int NN>
__device__ __forceinline__ void chol_solve_soa(const T (&L)[NN][NN], T (&x)[NN]) {
#pragma unroll
  for (int i = 0; i < NN; ++i) {
    T s = x[i];
#pragma unroll
    for (int j = 0; j < i; ++j) s = s - L[i][j] * x[j];
    x[i] = tdiv(s, L[i][i]);
  }
#pragma unroll
  for (int i = NN - 1; i >= 0; --i) {
    T s = x[i];
#pragma unroll
    for (int j = i + 1; j < NN; ++j) s = s - L[j][i] * x[j];
    x[i] = tdiv(s, L[i][i]);
  }
}

// Closed-form planar-chain right-hand side (rhs_soa): out = (ad, addot).
template <class T>
__device__ __forceinline__ void arm_rhs(const T (&x)[KM_NX], const float (&u)[KM_M],
                                        float w1, float w2, T (&out)[KM_NX]) {
  constexpr float C0[KM_NL][KM_NL] = KM_ARM_C0;   // l^2 m G[p][q]
  constexpr float C1[KM_NL] = KM_ARM_C1;          // m b[j]
  T th[KM_NL], thd[KM_NL];
  th[0] = x[0];
  thd[0] = x[KM_NL];
#pragma unroll
  for (int i = 1; i < KM_NL; ++i) {
    th[i] = th[i - 1] + x[i];
    thd[i] = thd[i - 1] + x[KM_NL + i];
  }
  T cos_pq[KM_NL][KM_NL], sin_pq[KM_NL][KM_NL];
#pragma unroll
  for (int p = 0; p < KM_NL; ++p) {
#pragma unroll
    for (int q = 0; q < p; ++q) {
      const T dth = th[p] - th[q];
      cos_pq[p][q] = tcos(dth);
      cos_pq[q][p] = cos_pq[p][q];
      sin_pq[p][q] = tsin(dth);
      sin_pq[q][p] = -sin_pq[p][q];
    }
  }
  const float l2w1 = KM_ARM_L2 * w1;
  T M_th[KM_NL][KM_NL];
#pragma unroll
  for (int p = 0; p < KM_NL; ++p) {
    M_th[p][p] = constant<T>((C0[p][p] + l2w1) + KM_ARM_IROT);
#pragma unroll
    for (int q = 0; q < p; ++q) {
      M_th[p][q] = (C0[p][q] + l2w1) * cos_pq[p][q];
      M_th[q][p] = M_th[p][q];
    }
  }
  T T1[KM_NL][KM_NL];                 // T1[p][j] = sum_{q >= j} M_th[p][q]
#pragma unroll
  for (int p = 0; p < KM_NL; ++p) {
    T1[p][KM_NL - 1] = M_th[p][KM_NL - 1];
#pragma unroll
    for (int j = KM_NL - 2; j >= 0; --j) T1[p][j] = T1[p][j + 1] + M_th[p][j];
  }
  T Dq[KM_NL][KM_NL];                 // Dq[i][j] = sum_{p >= i} T1[p][j]
#pragma unroll
  for (int j = 0; j < KM_NL; ++j) {
    Dq[KM_NL - 1][j] = T1[KM_NL - 1][j];
#pragma unroll
    for (int i = KM_NL - 2; i >= 0; --i) Dq[i][j] = Dq[i + 1][j] + T1[i][j];
  }
  T thd2[KM_NL];
#pragma unroll
  for (int q = 0; q < KM_NL; ++q) thd2[q] = thd[q] * thd[q];
  T s_row[KM_NL];
#pragma unroll
  for (int p = 0; p < KM_NL; ++p) {
    bool first = true;
#pragma unroll
    for (int q = 0; q < KM_NL; ++q) {
      if (q == p) continue;
      const T term = ((C0[p][q] + l2w1) * sin_pq[p][q]) * thd2[q];
      s_row[p] = first ? term : s_row[p] + term;
      first = false;
    }
    if (first) s_row[p] = constant<T>(0.0f);
  }
  T C[KM_NL], dPE[KM_NL];
  C[KM_NL - 1] = s_row[KM_NL - 1];
#pragma unroll
  for (int k = KM_NL - 2; k >= 0; --k) C[k] = C[k + 1] + s_row[k];
  T run = (C1[KM_NL - 1] + w1) * tsin(th[KM_NL - 1] - w2);
  dPE[KM_NL - 1] = KM_ARM_GL * run + KM_ARM_KSPR * x[KM_NL - 1];
#pragma unroll
  for (int k = KM_NL - 2; k >= 0; --k) {
    run = run + (C1[k] + w1) * tsin(th[k] - w2);
    dPE[k] = KM_ARM_GL * run + KM_ARM_KSPR * x[k];
  }
  T rhs[KM_NL];
#pragma unroll
  for (int k = 0; k < KM_NL; ++k) {
    const T tau = KM_ARM_NEG_KU * (u[k / KM_NLPM] - x[k]);
    rhs[k] = -(((C[k] + dPE[k]) + KM_ARM_DAMP * x[KM_NL + k]) + tau);
  }
  T L[KM_NL][KM_NL];
  chol_soa<T, KM_NL>(Dq, L);
  chol_solve_soa<T, KM_NL>(L, rhs);
#pragma unroll
  for (int k = 0; k < KM_NL; ++k) {
    out[k] = x[KM_NL + k];
    out[KM_NL + k] = rhs[k];
  }
}

// Iteration matrix M = I - gamma dt J and the Cholesky factor of M^T M.
__device__ __forceinline__ void sdirk2_factor(const float (&xs)[KM_NX],
                                              const float (&u)[KM_M], float w1,
                                              float w2, float gdt,
                                              float (&M)[KM_NX][KM_NX],
                                              float (&L)[KM_NX][KM_NX]) {
  {
    Dual xd[KM_NX], fd[KM_NX];
#pragma unroll
    for (int c = 0; c < KM_NX; ++c) {
      xd[c].v = xs[c];
#pragma unroll
      for (int k = 0; k < KM_NX; ++k) xd[c].d[k] = (k == c) ? 1.0f : 0.0f;
    }
    arm_rhs<Dual>(xd, u, w1, w2, fd);
#pragma unroll
    for (int r = 0; r < KM_NX; ++r) {
#pragma unroll
      for (int c = 0; c < KM_NX; ++c) M[r][c] = (r == c ? 1.0f : 0.0f) - gdt * fd[r].d[c];
    }
  }
  float Nm[KM_NX][KM_NX];
#pragma unroll
  for (int r = 0; r < KM_NX; ++r) {
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      float s = M[0][r] * M[0][c];
#pragma unroll
      for (int k = 1; k < KM_NX; ++k) s = s + M[k][r] * M[k][c];
      Nm[r][c] = s;
      Nm[c][r] = s;
    }
  }
  chol_soa<float, KM_NX>(Nm, L);
}

// One SDIRK2 stage by modified Newton: solves k = f(x_base + gamma dt k).
__device__ __forceinline__ void sdirk2_stage(const float (&xb)[KM_NX],
                                             const float (&u)[KM_M], float w1,
                                             float w2, float gdt,
                                             const float (&M)[KM_NX][KM_NX],
                                             const float (&L)[KM_NX][KM_NX],
                                             float (&k)[KM_NX]) {
#pragma unroll 1
  for (int it = 0; it < KM_NEWTON; ++it) {
    float xk[KM_NX], fx[KM_NX], res[KM_NX];
#pragma unroll
    for (int i = 0; i < KM_NX; ++i) xk[i] = xb[i] + gdt * k[i];
    arm_rhs<float>(xk, u, w1, w2, fx);
#pragma unroll
    for (int i = 0; i < KM_NX; ++i) res[i] = k[i] - fx[i];
    float Mtr[KM_NX];
#pragma unroll
    for (int i = 0; i < KM_NX; ++i) {
      float s = M[0][i] * res[0];
#pragma unroll
      for (int j = 1; j < KM_NX; ++j) s = s + M[j][i] * res[j];
      Mtr[i] = s;
    }
    chol_solve_soa<float, KM_NX>(L, Mtr);
#pragma unroll
    for (int i = 0; i < KM_NX; ++i) k[i] = k[i] - Mtr[i];
  }
}

// SDIRK2 over one control period in place (sdirk2_rows): gamma =
// 1 - 1/sqrt(2), chord Newton with the Jacobian taken once per period
// (jac_mode 'step').
__device__ __forceinline__ void sdirk2(float (&x)[KM_NX], const float (&u)[KM_M],
                                       float w1, float w2) {
  const float gamma = 1.0f - kdiv(1.0f, ksqrt(2.0f));
  const float gdt = gamma * KM_DT;
  const float omg = 1.0f - gamma;
  const float omg_dt = omg * KM_DT;
  float M[KM_NX][KM_NX], L[KM_NX][KM_NX];
  sdirk2_factor(x, u, w1, w2, gdt, M, L);
#pragma unroll 1
  for (int sub = 0; sub < KM_SUBSTEPS; ++sub) {
    float k1[KM_NX], k2[KM_NX], xb[KM_NX];
    arm_rhs<float>(x, u, w1, w2, k1);
    sdirk2_stage(x, u, w1, w2, gdt, M, L, k1);
#pragma unroll
    for (int i = 0; i < KM_NX; ++i) {
      xb[i] = x[i] + omg_dt * k1[i];
      k2[i] = k1[i];
    }
    sdirk2_stage(xb, u, w1, w2, gdt, M, L, k2);
#pragma unroll
    for (int i = 0; i < KM_NX; ++i) x[i] = x[i] + KM_DT * (omg * k1[i] + gamma * k2[i]);
  }
}

// Marker outputs from the joint angles (Arm.get_y): xy of every
// nlinks-th joint, origin dropped.
__device__ __forceinline__ void arm_outputs(const float (&x)[KM_NX], float (&y)[KM_NY]) {
  float th = 0.0f, rx = 0.0f, ry = 0.0f;
  int o = 0;
#pragma unroll
  for (int j = 0; j < KM_NL; ++j) {
    th = j == 0 ? x[0] : th + x[j];
    const float sx = KM_ARM_NEG_L * sinf(th);
    const float sy = KM_ARM_L * cosf(th);
    rx = j == 0 ? sx : rx + sx;
    ry = j == 0 ? sy : ry + sy;
    if (j % KM_NLPM == KM_NLPM - 1) {
      y[o++] = rx;
      y[o++] = ry;
    }
  }
}

#endif  // KM_NL

}  // namespace km
