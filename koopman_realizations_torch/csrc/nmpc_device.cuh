// Device functions of the SQP NMPC kernels (nmpc_multipass.cu,
// nmpc_stage.cu, nmpc_pass.cu): the composed dynamics F, the analytic
// stage Jacobian, the defects and the sensitivity condensation streamed
// into the factored Gram; one CUDA thread per lane.  The pass's QP from
// that Gram is nmpc_group.cuh's.
//
// They replace the NMPC device code of the JAX package: _eval_F_rows
// (ops/pallas/qp_ipm.py:1397), the in-kernel Jacobian J = A1 + G g_low and
// the defects (:1496-1528 and :1642-1676) and _nmpc_condense_core (:1082)
// with the factored Gram.  The plain PyTorch version of each is in
// ops/nmpc.py.
//
// One forward sweep over the stages serves every kernel: it asks a stage
// source for stage k's Jacobian and defects, propagates the sensitivities
// and feeds the stage's projected rows to the Gram (the narrow builds,
// n=12) or writes them out for the lane's group to form the Gram (the
// wide builds of the unblocked stack, n=27).  The sources are the
// trajectory rolled from the plan through F (optionally held at the first
// stage's point, F and J formed once), a shipped trajectory (Zl, Ul, Fv:
// J only) and shipped Jacobians and defects (no F, no J).
//
// The dynamics are F(x) = A1 x + A2 mono(x) + a0 with x = [zeta; u] and
// mono(x) the degree-blocked monomials; J(x) = A1 + unflatten(G g_low(x))
// with g_low = [x; monomials below the top degree].  The configuration
// header (ops/kernels/nmpc_multipass.py) carries the dimensions (KN_*),
// the stage column table and the monomial recurrence as straight-line
// statements, so g_low stays in statically indexed per-lane storage and
// each top-degree monomial is formed, used and dropped.  G is one f32
// array: the TPU kernel's bf16 hi/lo pairs and one-hot selector GEMMs
// have no counterpart here.
#pragma once

#include "kmpc_device.cuh"

#ifndef KN_NZ
#error "nmpc_device.cuh needs the NMPC configuration header"
#endif

#define KN_NU (KM_M + KM_N)              // condensation columns [u0 | moves]
#define KN_P ((KN_NP + 1) * KN_NPROJ)    // projected rows over the horizon

namespace km {

// Lane-shared operands of the NMPC solve (ops/nmpc.py:NmpcQP).
struct Nmpc {
  const float* A1;      // (KN_NZ, KN_NZA)
  const float* A2;      // (KN_NZ, KN_NMONO)
  const float* a0;      // (KN_NZ)
  const float* G;       // (KN_NZA * KN_NZ, KN_NLOWP), row i * KN_NZ + o
  const float* Gup;     // (KM_N, KM_M) pass-0 plan from u_prev
  const float* q0c;     // (KM_N) Levenberg coefficient -2 rho bsizes
  const float* CzS;     // (KN_P, KN_NS) sqrt(Q)-scaled projection
  const float* rdiag;   // (KM_N) blocked input cost + rho bsizes
  const float* cFr;     // (KM_MC)
  const float* F0r;     // (KM_MC, KM_M)
  Cons con;
};

// g_low = [z; u; lower monomial blocks; 0-pad].
__device__ __forceinline__ void g_low(const float (&z)[KN_NZ],
                                      const float (&u)[KM_M],
                                      float (&g)[KN_NLOWP]) {
#pragma unroll
  for (int i = 0; i < KN_NZ; ++i) g[i] = z[i];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) g[KN_NZ + j] = u[j];
  KN_GLOW(g);
#pragma unroll
  for (int i = KN_NLOW; i < KN_NLOWP; ++i) g[i] = 0.0f;
}

// F(z, u) and g_low.
__device__ __forceinline__ void eval_F(const Nmpc& op,
                                       const float (&z)[KN_NZ],
                                       const float (&u)[KM_M],
                                       float (&g)[KN_NLOWP],
                                       float (&F)[KN_NZ]) {
  g_low(z, u, g);
#pragma unroll
  for (int o = 0; o < KN_NZ; ++o) {
    float acc = ldg(op.A1 + o * KN_NZA);
    acc = acc * g[0];
#pragma unroll
    for (int i = 1; i < KN_NZA; ++i) acc = fmaf(ldg(op.A1 + o * KN_NZA + i), g[i], acc);
#pragma unroll
    for (int r = 0; r < KN_NLOW - KN_NZA; ++r)
      acc = fmaf(ldg(op.A2 + o * KN_NMONO + r), g[KN_NZA + r], acc);
    F[o] = acc + ldg(op.a0 + o);
  }
  // each top-degree monomial is formed and folded into F at once
#define KN_TERM(t, c)                                                     \
  {                                                                       \
    const float t_ = (t);                                                 \
    _Pragma("unroll") for (int o = 0; o < KN_NZ; ++o)                     \
        F[o] = fmaf(ldg(op.A2 + o * KN_NMONO + (c)), t_, F[o]);           \
  }
  KN_F_TOP(g, KN_TERM);
#undef KN_TERM
}

// J[i][o] = dF_o / dx_i = A1[o][i] + G row (i, o) . g_low (16-byte
// warp-uniform loads of G through the read-only cache).
__device__ __forceinline__ void stage_jacobian(const Nmpc& op,
                                               const float (&g)[KN_NLOWP],
                                               float (&J)[KN_NZA][KN_NZ]) {
  const float4* G4 = reinterpret_cast<const float4*>(op.G);
#pragma unroll
  for (int i = 0; i < KN_NZA; ++i) {
#pragma unroll
    for (int o = 0; o < KN_NZ; ++o) {
      const float4* row = G4 + (i * KN_NZ + o) * (KN_NLOWP / 4);
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < KN_NLOWP / 4; ++c) {
        const float4 w = __ldg(row + c);
        acc = fmaf(w.x, g[4 * c], acc);
        acc = fmaf(w.y, g[4 * c + 1], acc);
        acc = fmaf(w.z, g[4 * c + 2], acc);
        acc = fmaf(w.w, g[4 * c + 3], acc);
      }
      J[i][o] = ldg(op.A1 + o * KN_NZA + i) + acc;
    }
  }
}

// cv = F - Jz zl - Ju ul: the affine term of the linearization.
__device__ __forceinline__ void defects(const float (&F)[KN_NZ],
                                        const float (&J)[KN_NZA][KN_NZ],
                                        const float (&zl)[KN_NZ],
                                        const float (&ul)[KM_M],
                                        float (&cv)[KN_NZ]) {
#pragma unroll
  for (int o = 0; o < KN_NZ; ++o) {
    float c = F[o];
#pragma unroll
    for (int i = 0; i < KN_NZ; ++i) c = c - J[i][o] * zl[i];
#pragma unroll
    for (int j = 0; j < KM_M; ++j) c = c - J[KN_NZ + j][o] * ul[j];
    cv[o] = c;
  }
}

// Stage k's input block: u_prev at stage 0, else the moves of its group
// in the previous pass's x (decision rows cols[k] - m .. + m).
__device__ __forceinline__ void stage_input(int k, const float (&up)[KM_M],
                                            const float (&xp)[KM_N],
                                            float (&u)[KM_M]) {
  constexpr int COLS[KN_NP] = KN_COLS;
  const int g0 = k == 0 ? -KM_N - KM_M : COLS[k] - KM_M;   // stage 0: no row
#pragma unroll
  for (int j = 0; j < KM_M; ++j) {
    float v = up[j];
#pragma unroll
    for (int a = 0; a < KM_N; ++a) v = (a == g0 + j) ? xp[a] : v;
    u[j] = v;
  }
}

// Stage k's projected rows CzS_k [S | s] streamed into the Gram: with
// w = CzS_k,r S (KN_NU columns) and v = CzS_k,r s - sqRef + w[:m] u_prev,
// P += w[m:] w[m:]^T (lower triangle) and qv += w[m:] v.  The W block of
// the factored QP is never stored.
__device__ __forceinline__ void project_gram(const Nmpc& op, int k,
                                             const float (&S)[KN_NZ][KN_NU],
                                             const float (&s)[KN_NZ],
                                             const float (&up)[KM_M],
                                             const float* sqRef,
                                             long long sq_step,
                                             float (&P)[KM_N][KM_N],
                                             float (&qv)[KM_N]) {
#pragma unroll
  for (int r = 0; r < KN_NPROJ; ++r) {
    const int row = k * KN_NPROJ + r;
    const float* c = op.CzS + row * KN_NS;
    float w[KN_NU];
    float sv = ldg(c) * s[0];
#pragma unroll
    for (int col = 0; col < KN_NU; ++col) w[col] = ldg(c) * S[0][col];
#pragma unroll
    for (int i = 1; i < KN_NS; ++i) {
      const float ci = ldg(c + i);
      sv = fmaf(ci, s[i], sv);
#pragma unroll
      for (int col = 0; col < KN_NU; ++col) w[col] = fmaf(ci, S[i][col], w[col]);
    }
    float v = sv - sqRef[row * sq_step];
#pragma unroll
    for (int j = 0; j < KM_M; ++j) v = fmaf(w[j], up[j], v);
#pragma unroll
    for (int a = 0; a < KM_N; ++a) {
      qv[a] = fmaf(w[KM_M + a], v, qv[a]);
#pragma unroll
      for (int b = 0; b <= a; ++b) P[a][b] = fmaf(w[KM_M + a], w[KM_M + b], P[a][b]);
    }
  }
}

// S <- Jz S with Ju added at the stage's columns [ck, ck + m);
// s <- Jz s + cv.
__device__ __forceinline__ void propagate(int ck,
                                          const float (&J)[KN_NZA][KN_NZ],
                                          const float (&cv)[KN_NZ],
                                          float (&S)[KN_NZ][KN_NU],
                                          float (&s)[KN_NZ]) {
#pragma unroll
  for (int col = 0; col < KN_NU; ++col) {
    float t[KN_NZ];
#pragma unroll
    for (int o = 0; o < KN_NZ; ++o) {
      float acc = J[0][o] * S[0][col];
#pragma unroll
      for (int i = 1; i < KN_NZ; ++i) acc = fmaf(J[i][o], S[i][col], acc);
#pragma unroll
      for (int j = 0; j < KM_M; ++j) acc = (col == ck + j) ? acc + J[KN_NZ + j][o] : acc;
      t[o] = acc;
    }
#pragma unroll
    for (int o = 0; o < KN_NZ; ++o) S[o][col] = t[o];
  }
  float t[KN_NZ];
#pragma unroll
  for (int o = 0; o < KN_NZ; ++o) {
    float acc = J[0][o] * s[0];
#pragma unroll
    for (int i = 1; i < KN_NZ; ++i) acc = fmaf(J[i][o], s[i], acc);
    t[o] = acc + cv[o];
  }
#pragma unroll
  for (int o = 0; o < KN_NZ; ++o) s[o] = t[o];
}

// ------------------------------------------------------- stage sources
// A source fills stage k's Jacobian J[i][o] = dF_o/dx_i and defects cv
// when the sweep asks for them, in stage order.

// Stage inputs of a rolled trajectory: u_prev at stage 0, then the group
// moves of the previous pass's x (the multipass kernel) ...
struct PlanInput {
  const float (&up)[KM_M];
  const float (&xp)[KM_N];
  __device__ __forceinline__ void operator()(int k, float (&u)[KM_M]) const {
    stage_input(k, up, xp, u);
  }
};
// ... u_prev at every stage (the held first pass) ...
struct HeldInput {
  const float (&up)[KM_M];
  __device__ __forceinline__ void operator()(int, float (&u)[KM_M]) const {
#pragma unroll
    for (int j = 0; j < KM_M; ++j) u[j] = up[j];
  }
};
// ... or of the previous pass's x in the lane region (shared memory; the
// wide multipass build, whose x stays out of the sweep's registers) ...
struct SharedPlanInput {
  const float (&up)[KM_M];
  const float* x;
  __device__ __forceinline__ void operator()(int k, float (&u)[KM_M]) const {
    constexpr int COLS[KN_NP] = KN_COLS;
#pragma unroll
    for (int j = 0; j < KM_M; ++j) u[j] = k == 0 ? up[j] : x[COLS[k] - KM_M + j];
  }
};
// ... or the lane's shipped plan Ul (KN_NP * KM_M rows, lanes-minor; the
// pointer at the lane).
struct LaneInput {
  const float* Ul;
  long long B;
  __device__ __forceinline__ void operator()(int k, float (&u)[KM_M]) const {
#pragma unroll
    for (int j = 0; j < KM_M; ++j) u[j] = Ul[(k * KM_M + j) * B];
  }
};

// The trajectory rolled through F from zeta along the stage inputs; with
// ``hold`` every stage is linearized at stage 0's point (F and J formed
// once).
template <class In>
struct RolledStages {
  const Nmpc& op;
  In in;
  bool hold;
  float z[KN_NZ];
  __device__ __forceinline__ RolledStages(const Nmpc& op_, In in_, bool hold_,
                                          const float (&zeta)[KN_NZ])
      : op(op_), in(in_), hold(hold_) {
#pragma unroll
    for (int o = 0; o < KN_NZ; ++o) z[o] = zeta[o];
  }
  __device__ __forceinline__ void operator()(int k, float (&J)[KN_NZA][KN_NZ],
                                             float (&cv)[KN_NZ]) {
    if (!hold || k == 0) {
      float u[KM_M], g[KN_NLOWP], F[KN_NZ];
      in(k, u);
      eval_F(op, z, u, g, F);
      stage_jacobian(op, g, J);
      defects(F, J, z, u, cv);
#pragma unroll
      for (int o = 0; o < KN_NZ; ++o) z[o] = F[o];
    }
  }
};

// A shipped trajectory: stage k at (Zl_k, Ul_k) with dynamics values Fv_k
// (Zl, Fv: KN_NP * KN_NZ rows, Ul: KN_NP * KM_M rows, lanes-minor; the
// pointers at the lane).  J is formed, F is not.
struct ShippedStages {
  const Nmpc& op;
  const float* Zl;
  const float* Ul;
  const float* Fv;
  long long B;
  __device__ __forceinline__ void operator()(int k, float (&J)[KN_NZA][KN_NZ],
                                             float (&cv)[KN_NZ]) const {
    float zl[KN_NZ], ul[KM_M], F[KN_NZ], g[KN_NLOWP];
#pragma unroll
    for (int o = 0; o < KN_NZ; ++o) {
      zl[o] = Zl[(k * KN_NZ + o) * B];
      F[o] = Fv[(k * KN_NZ + o) * B];
    }
#pragma unroll
    for (int j = 0; j < KM_M; ++j) ul[j] = Ul[(k * KM_M + j) * B];
    g_low(zl, ul, g);
    stage_jacobian(op, g, J);
    defects(F, J, zl, ul, cv);
  }
};

// Shipped stage Jacobians and defects: Jt (KN_NP, KN_NZA, KN_NZ) and cv
// (KN_NP, KN_NZ) per lane, lanes-minor (the pointers at the lane), each
// element read once, coalesced over the lanes.
struct ShippedJacobians {
  const float* Jt;
  const float* cv;
  long long B;
  __device__ __forceinline__ void operator()(int k, float (&J)[KN_NZA][KN_NZ],
                                             float (&c)[KN_NZ]) const {
#pragma unroll
    for (int i = 0; i < KN_NZA; ++i) {
#pragma unroll
      for (int o = 0; o < KN_NZ; ++o) J[i][o] = Jt[((k * KN_NZA + i) * KN_NZ + o) * B];
    }
#pragma unroll
    for (int o = 0; o < KN_NZ; ++o) c[o] = cv[(k * KN_NZ + o) * B];
  }
};

// ------------------------------------------------------------ the sweep

// Where a sweep's projected rows go: streamed into the Gram in the
// thread's registers (the narrow builds) ...
struct GramSink {
  const Nmpc& op;
  const float (&up)[KM_M];
  const float* sqRef;
  long long sq_step;
  float (&P)[KM_N][KM_N];
  float (&qv)[KM_N];
  // P starts as diag(rdiag) (lower triangle), qv as 0
  __device__ __forceinline__ GramSink(const Nmpc& op_,
                                      const float (&up_)[KM_M],
                                      const float* sqRef_, long long step,
                                      float (&P_)[KM_N][KM_N],
                                      float (&qv_)[KM_N])
      : op(op_), up(up_), sqRef(sqRef_), sq_step(step), P(P_), qv(qv_) {
#pragma unroll
    for (int a = 0; a < KM_N; ++a) {
      qv[a] = 0.0f;
#pragma unroll
      for (int b = 0; b <= a; ++b) P[a][b] = 0.0f;
      P[a][a] = ldg(op.rdiag + a);
    }
  }
  __device__ __forceinline__ void operator()(
      int k, const float (&S)[KN_NZ][KN_NU], const float (&s)[KN_NZ]) const {
    project_gram(op, k, S, s, up, sqRef, sq_step, P, qv);
  }
};

// ... or written out as rows [w[m:] (KM_N) | v] of the lane's scratch
// row, row k * KN_NPROJ + r at (KM_N + 1) floats a row, for its group to
// form the Gram (the wide builds: at n=27 the Gram's lower triangle is
// 378 floats, more than a thread's registers beside the sensitivities).
struct RowSink {
  const Nmpc& op;
  const float (&up)[KM_M];
  const float* sqRef;
  long long sq_step;
  float* rows;
  __device__ __forceinline__ void operator()(
      int k, const float (&S)[KN_NZ][KN_NU], const float (&s)[KN_NZ]) const {
#pragma unroll 1
    for (int r = 0; r < KN_NPROJ; ++r) {
      const int row = k * KN_NPROJ + r;
      const float* c = op.CzS + row * KN_NS;
      float* out = rows + row * (KM_N + 1);
      float sv = ldg(c) * s[0];
#pragma unroll
      for (int i = 1; i < KN_NS; ++i) sv = fmaf(ldg(c + i), s[i], sv);
      float v = sv - sqRef[row * sq_step];
      // the u_0 columns fold into v; each move column is one entry of w
#pragma unroll
      for (int col = 0; col < KN_NU; ++col) {
        float w = ldg(c) * S[0][col];
#pragma unroll
        for (int i = 1; i < KN_NS; ++i) w = fmaf(ldg(c + i), S[i][col], w);
        if (col < KM_M)
          v = fmaf(w, up[col], v);
        else
          out[col - KM_M] = w;
      }
      out[KM_N] = v;
    }
  }
};

// One SQP pass's forward sweep over the stages: it takes each stage's
// Jacobian and defects from the source, propagates S and s, and hands
// each stage's projected rows to the sink (GramSink: the QP's P, lower
// triangle with the input cost on the diagonal, and qv, both before the
// factor 2; RowSink: the rows themselves).
template <class Stages, class Sink>
__device__ __forceinline__ void condense_sweep(const Nmpc& op, Stages& stages,
                                               const float (&zeta)[KN_NZ],
                                               const Sink& sink) {
  constexpr int COLS[KN_NP] = KN_COLS;
  float S[KN_NZ][KN_NU], s[KN_NZ];
#pragma unroll
  for (int o = 0; o < KN_NZ; ++o) {
    s[o] = zeta[o];
#pragma unroll
    for (int col = 0; col < KN_NU; ++col) S[o][col] = 0.0f;
  }
  float J[KN_NZA][KN_NZ], cv[KN_NZ];
#pragma unroll 1
  for (int k = 0; k <= KN_NP; ++k) {
    sink(k, S, s);
    if (k == KN_NP) break;
    stages(k, J, cv);
    propagate(COLS[k], J, cv, S, s);
  }
}

}  // namespace km
