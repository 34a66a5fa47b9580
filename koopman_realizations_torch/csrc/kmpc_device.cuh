// Device functions shared by the CUDA kernels of the Koopman MPC closed
// loops: the interior point's constants, constraint rows and scalar
// helpers (the cooperative interior point of ipm_group.cuh runs on them
// in every kernel that solves a QP); the objective scale of a per-lane
// Gram (the bilinear kernels, the NMPC kernels); the factored Gram
// streamed from W rows (the bilinear kernels); the poly lift (the two step
// kernels and bilin_lift.cu); the bilinear QP assembly against
// lane-shared generators from the lift's features or the lifted state,
// without the generator stack's all-zero rows (bilin_lift.cu,
// step_fused.cu, bilin.cu: each lane's thread assembles, then hands the
// QP to a group of threads); the arm's closed-form right-hand side with
// dual numbers, SDIRK2, the marker kinematics and the step kernels' carry
// (step_fused.cu, linear_step_fused.cu through step_group.cuh).
//
// They replace the shared Pallas device functions of the JAX package
// (ops/pallas/qp_ipm.py:686-769, ops/pallas/step_fused.py
// _plant_freeze_epilogue :150, models/arm_lanes.py sdirk2_rows), one CUDA
// thread per scenario lane.  Per-lane operands are lanes-minor (row r of
// lane b at r * B + b), so every per-lane load and store of a warp is
// coalesced; lane-shared operands are read through the read-only cache,
// where a warp's identical addresses are one broadcast.
//
// The dimensions, the monomial recurrence and the plant constants are
// compile-time constants of one configuration: the build generates a
// header with them (ops/kernels/_build.py), so every per-lane array has a
// static size and static indices after unrolling.  A section below is
// compiled only where its part of the configuration is defined: KM_N,
// KM_MC, KM_BAND (the interior point; KM_BAND -1 with KM_RNZ: the dense
// A^T D A), KM_M (the right-hand side b), KM_P (the factored Gram),
// KM_NCP (the assembly against generators, with the generator stack's
// live-row table KM_LIVE_W/H/P), KM_NZ (the lift), KM_NZL (the lifted
// state as features), KM_NL (the plant).
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

#define KM_PN (KM_P * KM_N)           // W rows of the generator stack
#define KM_MP (KM_M * KM_P)           // CB0 rows
#define KM_NF (KM_NZ + KM_NMONO)      // features [zeta; monomials]

namespace km {

constexpr float kReg = 1e-7f;         // primal regularization (scaled)
constexpr float kMuFloor = 1e-8f;     // converged-lane freeze
constexpr float kTol = 3e-3f;         // ok: primal residual tolerance
constexpr float kGapSane = 5e-2f;     // ok: complementarity gap bound

// Lane-shared constraint rows A x <= b, row-equilibrated, and the
// A^T D A tables (ops/qp.py:Constraints).
struct Cons {
  const float* A;       // (KM_MC, KM_N)
  const float* Wd;      // (KM_N, KM_MC) diagonal A^T D A table; dense:
                        // (KM_MC, KM_RNZ) each row's nonzero values
  const float* Wo;      // (KM_N - KM_BAND, KM_MC) off-band table
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

// Per-lane objective scale: max |P| is the max diagonal of the PSD Gram.
__device__ __forceinline__ float diag_obj_scale(const float (&P)[KM_N][KM_N]) {
  float obj = P[0][0];
#pragma unroll
  for (int j = 1; j < KM_N; ++j) obj = nmax(obj, P[j][j]);
  return nmax(obj, 1e-8f);
}

#ifdef KM_M
// b = cFr - F0r u_prev: one lane's constraint right-hand side.
__device__ __forceinline__ void rhs_b(const float* cFr, const float* F0r,
                                      const float (&up)[KM_M],
                                      float (&b)[KM_MC]) {
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
    float bc = ldg(cFr + c);
#pragma unroll
    for (int j = 0; j < KM_M; ++j)
      bc = bc - ldg(F0r + c * KM_M + j) * up[j];
    b[c] = bc;
  }
}
#endif  // KM_M

// ------------------------------------------------------------------ lift
#ifdef KM_NZ

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

#endif  // KM_NZ

#ifdef KM_NCP

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

#endif  // KM_NCP

// -------------------------------------------------------- bilinear QP
#if defined(KM_P) && defined(KM_NCP)

// Lane-shared operands of the bilinear QP assembled in-kernel
// (ops/qp.py:LiftQP, BilinQP).
struct QP {
  const float* gens;    // (KM_PN + KM_MP + KM_P, KM_NCP) generator stack
  const float* rdiag;   // (KM_N) blocked input cost
  const float* cFr;     // (KM_MC)
  const float* F0r;     // (KM_MC, KM_M)
  Cons con;
};

// The features the generator columns act on: the poly lift of the raw
// zeta (bilin_lift.cu, step_fused.cu), or the lane's lifted state z read
// lanes-minor (bilin.cu; z carries its constant 1 itself).
#ifdef KM_NZ
struct LiftFeatures {
  const float (&zeta)[KM_NZ];
  __device__ __forceinline__ void operator()(float (&f)[KM_NCP]) const {
    lift_features(zeta, f);
  }
};
#endif
#ifdef KM_NZL
struct StateFeatures {
  const float* z;       // (KM_NZL, B) at the lane
  long long B;
  __device__ __forceinline__ void operator()(float (&f)[KM_NCP]) const {
#pragma unroll
    for (int i = 0; i < KM_NZL; ++i) f[i] = z[i * B];
#pragma unroll
    for (int i = KM_NZL; i < KM_NCP; ++i) f[i] = 0.0f;
  }
};
#endif

// The factored Gram (qp_ipm.py:760-769; the factored mode of _ipm_kernel,
// :340-367), streaming W: each of the p rows is fetched from a row source,
// accumulated into P and qv, and dropped -- the per-lane (p*n) W block is
// never held.  The source fills the live entries of row r of W and
// returns v_r; only those enter P and qv.  The rows run in stage order,
// a run of rows with one mask of live entries (KM_LIVE_W: {first, end,
// mask}, bit i for W[r, i]) at a time, each run's loop specialized to its
// mask.
//   P = 2 (sum_r W_r W_r^T + diag(rdiag)),  qv = 2 sum_r W_r v_r
template <class Rows>
__device__ __forceinline__ void factored_gram(const float* rdiag,
                                              const Rows& rows,
                                              float (&P)[KM_N][KM_N],
                                              float (&qv)[KM_N]) {
  constexpr unsigned RUNS[KM_NLIVE_W][3] = KM_LIVE_W;
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    qv[i] = 0.0f;
#pragma unroll
    for (int k = 0; k <= i; ++k) P[i][k] = 0.0f;
    P[i][i] = ldg(rdiag + i);
  }
#pragma unroll
  for (int run = 0; run < KM_NLIVE_W; ++run) {
    const unsigned live = RUNS[run][2];
    if (live == 0u) continue;
#pragma unroll 1
    for (int r = RUNS[run][0]; r < (int)RUNS[run][1]; ++r) {
      float w[KM_N];
      const float vr = rows(r, live, w);
#pragma unroll
      for (int i = 0; i < KM_N; ++i) {
        if (!(live >> i & 1u)) continue;
        qv[i] = fmaf(w[i], vr, qv[i]);
#pragma unroll
        for (int k = 0; k <= i; ++k)
          if (live >> k & 1u) P[i][k] = fmaf(w[i], w[k], P[i][k]);
      }
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
}

// W's rows generated against the features: row r's live entries
// (``live``: bit i for W[r, i]) are one generator row each.
struct GenRows {
  const float* gW;
  const float (&f)[KM_NCP];
  const float (&v)[KM_P];
  __device__ __forceinline__ float operator()(int r, unsigned live,
                                              float (&w)[KM_N]) const {
#pragma unroll
    for (int i = 0; i < KM_N; ++i)
      if (live >> i & 1u) w[i] = gen_row(gW + (r * KM_N + i) * KM_NCP, f);
    return v[r];
  }
};

// Features, assembly and factored Gram (qp_ipm.py:727-769 and
// :1036-1062): v is formed first, then W is streamed into the Gram.
//   v = Pgen f - sqYr + CB0 u_prev,  b = cFr - F0r u_prev
// The generator stack's structural zeros are left out: the build's
// live-row table (ops/kernels/bilin_lift.py:live_config, from
// ops/qp.py:generator_live) gives, for the W, CB0 and v generators, the
// runs of consecutive stage rows r with one mask of live rows {first r,
// end r, mask} (W: bit i for W[r, i]; CB0: bit j for CB0[r, j]; v: 1).
// A row outside its mask is all zero in the lane-shared stack: no
// generator read and no product is made with it, and the Gram forms no
// term with its W entry (W's stages that no move block reaches, CB0's
// stages that u_prev does not reach).  The table comes from the stack's
// exact zeros, not from the move blocks' pattern (the CPU tests check
// that the two agree on the committed model), and that is safe whatever
// made a row zero: for finite features the skipped product is an exact
// +0 and each skipped term adds nothing (fmaf(0, x, acc) == acc; no sum
// here is -0), so the result is bitwise the full assembly's.  Only a lane
// with a non-finite feature differs -- the full assembly made
// 0 * inf = NaN in the zero rows -- and its live rows carry the NaN all
// the same (every v row is live): it comes out not ok, as before.
template <class Feat>
__device__ __forceinline__ void assemble(const QP& qp, const Feat& feat,
                                         const float (&up)[KM_M],
                                         const float* sqYr, long long sq_step,
                                         float (&P)[KM_N][KM_N],
                                         float (&qv)[KM_N],
                                         float (&b)[KM_MC]) {
  constexpr unsigned RUNS_H[KM_NLIVE_H][3] = KM_LIVE_H;
  constexpr unsigned RUNS_P[KM_NLIVE_P][3] = KM_LIVE_P;
  float f[KM_NCP];
  feat(f);
  const float* gW = qp.gens;
  const float* gH = qp.gens + (long long)KM_PN * KM_NCP;
  const float* gP = gH + (long long)KM_MP * KM_NCP;
  // row loops stay rolled (the unrolled assembly would not fit the
  // instruction cache); v lives in local memory
  float v[KM_P];
#pragma unroll
  for (int run = 0; run < KM_NLIVE_P; ++run) {
#pragma unroll 1
    for (int r = RUNS_P[run][0]; r < (int)RUNS_P[run][1]; ++r)
      v[r] = (RUNS_P[run][2] ? gen_row(gP + r * KM_NCP, f) : 0.0f)
             - sqYr[r * sq_step];
  }
#pragma unroll
  for (int j = 0; j < KM_M; ++j) {
#pragma unroll
    for (int run = 0; run < KM_NLIVE_H; ++run) {
      if (!(RUNS_H[run][2] >> j & 1u)) continue;
#pragma unroll 1
      for (int r = RUNS_H[run][0]; r < (int)RUNS_H[run][1]; ++r)
        v[r] = fmaf(gen_row(gH + (j * KM_P + r) * KM_NCP, f), up[j], v[r]);
    }
  }
  factored_gram(qp.rdiag, GenRows{gW, f, v}, P, qv);
  rhs_b(qp.cFr, qp.F0r, up, b);
}

#endif  // KM_P && KM_NCP


// ----------------------------------------------------------------- plant
// Arm plant (models/arm_lanes.py) and the step kernels' tail: only in
// builds whose configuration header carries the plant constants.
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
// (jac_mode 'step'), or at the start of every substep (KM_JAC_SUBSTEP,
// jac_mode 'substep': arm_lanes.py:293-302 of the JAX package, the
// plain models/arm_lanes.py's 'substep' branch).
__device__ __forceinline__ void sdirk2(float (&x)[KM_NX], const float (&u)[KM_M],
                                       float w1, float w2) {
  const float gamma = 1.0f - kdiv(1.0f, ksqrt(2.0f));
  const float gdt = gamma * KM_DT;
  const float omg = 1.0f - gamma;
  const float omg_dt = omg * KM_DT;
  float M[KM_NX][KM_NX], L[KM_NX][KM_NX];
#if !(defined(KM_JAC_SUBSTEP) && KM_JAC_SUBSTEP)
  sdirk2_factor(x, u, w1, w2, gdt, M, L);
#endif
#pragma unroll 1
  for (int sub = 0; sub < KM_SUBSTEPS; ++sub) {
#if defined(KM_JAC_SUBSTEP) && KM_JAC_SUBSTEP
    sdirk2_factor(x, u, w1, w2, gdt, M, L);
#endif
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

// The outputs from the joint angles (Arm.get_y): the angles as they are
// (KM_ANGLES, output_type 'angles', KM_NY = KM_NL; _markers_rows,
// ops/pallas/step_fused.py:61-70 of the JAX package), else the markers:
// xy of every nlinks-th joint, origin dropped.
__device__ __forceinline__ void arm_outputs(const float (&x)[KM_NX], float (&y)[KM_NY]) {
#if defined(KM_ANGLES) && KM_ANGLES
#pragma unroll
  for (int j = 0; j < KM_NL; ++j) y[j] = x[j];
#else
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
#endif
}

// Lanes-minor carries of the fused step kernels
// (ops/kernels/step_fused.py:StepCarry): the inputs and the outputs, which
// may alias them (step_group.cuh: the front launch writes no carry field,
// the solve launch reads each element before it writes it).
struct StepIO {
  const float* ysc;      // (KM_NY, B) scaled outputs == zeta
  const float* upsc;     // (KM_M, B) previous input, scaled
  const float* xpl;      // (KM_NX, B) plant state
  const float* w;        // (2, B) loads
  const float* alive;    // (B) 1 / 0
  const float* x0;       // (KM_N, B) primal start
  const float* lamc;     // (KM_MC, B) dual carry
  const float* yp;       // (KM_NPROJ, B) tracked outputs
  float* ysc_o;
  float* upsc_o;
  float* xpl_o;
  float* alive_o;
  float* x0_o;
  float* lamc_o;
  float* yp_o;
};

#endif  // KM_NL

}  // namespace km
