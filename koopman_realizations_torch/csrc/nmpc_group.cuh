// The NMPC kernels on the skeleton of lane_group.cuh: each thread sweeps
// one lane's stages (nmpc_device.cuh), hands the pass's scaled Hessian
// and q over through its scratch row, and the block then solves its
// lanes' QPs a group of KG_GROUP threads a lane (ipm_group.cuh).  Three
// kernels use it: nmpc_multipass.cu (every SQP pass of a step in one
// launch), nmpc_stage.cu and nmpc_pass.cu (one pass a launch, in two
// launches: the sweep, then the group solve).
//
// The three differ in three things, each a parameter here:
// - the Levenberg term of q: q0c * x_prev (multipass, from the previous
//   pass's x), or a per-lane q0 from memory or none (the one-pass
//   kernels), added as 2 W^T v + term before the objective scale;
// - the dual start: cold (lam = 1), or warm from a per-lane lam0
//   (kl::LaneDuals), the lane's obj read from its lane region;
// - the primal start in the lane region's x slot: x_prev (multipass) or
//   the shipped x0 (the one-pass kernels), each written by the lane's
//   thread with loads coalesced over the lanes.
//
// Layout (ops/kernels/ipm_group.py, the compact plan): the lane region
// [x: n][obj: 1][u_prev: m]; the scratch row [Pr: T][q: n]; the work
// region [M: T][dx: n][vec: mc][Pr: T], the Hessian copied from the
// scratch row.  The wide builds (n=27, KG_S_W: a warp a lane) hand the
// pass's projected rows over instead, the scratch row [W: p (n + 1)],
// and the group forms the Gram from a copy of them after the Hessian in
// its work region [M][dx][vec][Pr][W rows]: a thread's registers hold the
// sensitivities (6 x 30 at n=27) but not a Gram of 378 entries beside
// them.
#pragma once

#include "lane_group.cuh"
#include "nmpc_device.cuh"

namespace kn {

// ------------------------------------------------------- the Levenberg term
// q0c * x_prev (multipass) ...
struct LevenbergTerm {
  const float* q0c;
  const float (&xp)[KM_N];
  __device__ __forceinline__ float operator()(int i) const {
    return km::ldg(q0c + i) * xp[i];
  }
};
// ... or a per-lane q0 (KM_N rows, lanes-minor; the pointer at the lane),
// none where null.
struct LaneTerm {
  const float* q0;
  long long B;
  __device__ __forceinline__ float operator()(int i) const {
    return q0 ? q0[i * B] : 0.0f;
  }
};

#ifdef KG_S_PR
// The pass's QP from the swept Gram, as the thread-per-lane kernels
// formed it before their Mehrotra loop: P = 2 (W^T W + diag(rdiag)),
// q = 2 W^T v + term, then the objective scale and the scaled,
// regularized Hessian and q into the lane's scratch row H
// (kl::pack_scaled).  Returns obj.
template <class Term>
__device__ __forceinline__ float hand_over(float (&Pr)[KM_N][KM_N],
                                           float (&q)[KM_N],
                                           const Term& term, float* H) {
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    q[i] = 2.0f * q[i] + term(i);
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      Pr[i][k] *= 2.0f;
      Pr[k][i] = Pr[i][k];
    }
  }
  return kl::pack_scaled(Pr, q, H);
}
#endif

#ifdef KG_S_W
// ------------------------------------- the wide builds' Gram by the group
// The lane's thread hands the pass's KN_P projected rows [w | v] over in
// its scratch row (km::RowSink); the group copies them into its work
// region after the Hessian (KG_W_ROWS) and forms the QP there, as
// ipm_factored forms it from W: thread g holds the packed lower-triangle
// entries t = g + G j of P = 2 (W^T W + diag(rdiag)), summed over the rows
// in row order from diag(rdiag), and entry i = g + G o of q = 2 W^T v +
// term(i); the objective scale max diag(P) from the entries' owners in
// column order; the scaled, regularized Hessian into the work region
// (KG_W_PR), q / obj over the rows' first entries, obj into the lane
// region.
#define KG_W_ROWS (KG_W_PR + KG_T)           // work region: the W rows

// The Levenberg term of the multipass kernel for the group: q0c * x_prev,
// x_prev the lane region's x before the solve.
struct XprevTerm {
  const float* q0c;
  const float* H;
  __device__ __forceinline__ float operator()(int i) const {
    return km::ldg(q0c + i) * H[KG_L_X + i];
  }
};

template <class Term>
struct GramHessian {
  float* H;             // the lane region
  const float* rdiag;
  Term term;
  __device__ __forceinline__ void load(float*, int) const {}
  __device__ __forceinline__ float* operator()(float* w, const float* hs,
                                               int g) const {
    constexpr int kRow = KM_N + 1;
    float* rows = w + KG_W_ROWS;
    for (int t = g; t < KN_P * kRow; t += KG_GROUP) rows[t] = hs[KG_S_W + t];
    kg::gsync();
    int ti[KG_NT], tk[KG_NT];
    float P[KG_NT], qv[KG_NO];
#pragma unroll
    for (int j = 0; j < KG_NT; ++j) {
      const int t = g + KG_GROUP * j;
      tk[j] = t < KG_T ? kg::tcol(t) : 0;
      ti[j] = t < KG_T ? tk[j] + t - kg::off(tk[j]) : 0;
      P[j] = (t < KG_T && ti[j] == tk[j]) ? km::ldg(rdiag + ti[j]) : 0.0f;
    }
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) qv[o] = 0.0f;
#pragma unroll 1
    for (int r = 0; r < KN_P; ++r) {
      const float* wr = rows + r * kRow;
      const float vr = wr[KM_N];
#pragma unroll
      for (int j = 0; j < KG_NT; ++j)
        if (g + KG_GROUP * j < KG_T) P[j] = fmaf(wr[ti[j]], wr[tk[j]], P[j]);
#pragma unroll
      for (int o = 0; o < KG_NO; ++o) {
        const int i = g + KG_GROUP * o;
        if (i < KM_N) qv[o] = fmaf(wr[i], vr, qv[o]);
      }
    }
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
    kg::gsync();          // every row read before q overwrites them
    float* Pr = w + KG_W_PR;
#pragma unroll
    for (int j = 0; j < KG_NT; ++j) {
      const int t = g + KG_GROUP * j;
      if (t < KG_T) Pr[t] = P[j] * iobj + (ti[j] == tk[j] ? km::kReg : 0.0f);
    }
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      if (i < KM_N) rows[i] = (2.0f * qv[o] + term(i)) * iobj;
    }
    if (g == 0) H[KG_L_OBJ] = obj;
    kg::gsync();
    return Pr;
  }
};

// q to its owners from the rows' first entries (GramHessian).
struct GramGradient {
  const float* q;
  __device__ __forceinline__ void operator()(const float*, const float*,
                                             long long, int g,
                                             float (&qo)[KG_NO]) const {
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      qo[o] = i < KM_N ? q[i] : 0.0f;
    }
  }
};
#endif

// What a pass's group does with its lane's solution: with ``last`` it
// stores s and lam of a lane in the batch.
template <class Args>
struct StoreDuals {
  const Args& a;
  bool last;
  __device__ __forceinline__ void operator()(
      const kg::Shared&, const kg::Lane&, float*, const float*, long long b,
      int g, const float (&)[KG_R], const float (&s)[KG_R],
      const float (&lam)[KG_R]) const {
    if (!last || b >= a.B) return;
#pragma unroll
    for (int k = 0; k < KG_R; ++k) {
      const int c = g + KG_GROUP * k;
      if (c < KM_MC) {
        a.s[c * a.B + b] = s[k];
        a.lam[c * a.B + b] = lam[k];
      }
    }
  }
};

// One lane's pass QP by its group (kl::solve_lane): the Hessian and q
// from the lane's scratch row, b from u_prev in the lane region, the
// dual start; with ``last`` the group stores s and lam.  Args has op,
// scratch, s, lam, B and iters.
// The wide builds form the Gram by the group first (GramHessian, with the
// Levenberg term ``term``; the narrow builds added theirs in hand_over).
template <class Args, class Term, class Duals>
__device__ __forceinline__ void solve_lane(const Args& a,
                                           const kg::Shared& sh, float* sm,
                                           int ql, int grp, int g, bool last,
                                           float slack_floor,
                                           const Term& term,
                                           const Duals& duals) {
#ifdef KG_S_W
  float* w = kg::work_region(sm, grp);
  kl::solve_lane(a, a.op.cFr, a.op.F0r, sh, sm, ql, grp, g, slack_floor,
                 GramHessian<Term>{kg::lane_region(sm, ql), a.op.rdiag, term},
                 GramGradient{w + KG_W_ROWS}, duals,
                 StoreDuals<Args>{a, last});
#else
  (void)term;
  kl::solve_lane(a, a.op.cFr, a.op.F0r, sh, sm, ql, grp, g, slack_floor,
                 kl::ScratchHessian{}, kl::ScratchGradient{}, duals,
                 StoreDuals<Args>{a, last});
#endif
}

// ------------------------------------------------------ one pass a launch
// Args (StageArgs, PassArgs) has op, zeta, up, sqRef, x0, q0, lam0, x, s,
// lam, obj, scratch, B, sqRef_lanes, iters and slack_floor; Sweep(b, zeta,
// up, sink) runs lane b's condense_sweep over its source into the sink.

// The sweep launch (KG_LANES == KG_THREADS: a thread a lane): every lane
// of the grid swept (lanes past the batch along the last lane's data) and
// handed over into its scratch row, obj stored for the lanes in the batch.
template <class Args, class Sweep>
__device__ __forceinline__ void sweep_pass(const Args& a, const Sweep& sweep) {
  const long long B = a.B;
  const long long b = (long long)blockIdx.x * KG_LANES + threadIdx.x;
  const bool live = b < B;
  const long long bl = live ? b : B - 1;
  float up[KM_M], zeta[KN_NZ];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.up[j * B + bl];
#pragma unroll
  for (int i = 0; i < KN_NZ; ++i) zeta[i] = a.zeta[i * B + bl];
  const float* sq = a.sqRef_lanes ? a.sqRef + bl : a.sqRef;
  const long long sq_step = a.sqRef_lanes ? B : 1;
#ifdef KG_S_W
  (void)live;
  sweep(bl, zeta, up, km::RowSink{a.op, up, sq, sq_step,
                                  kl::scratch_row(a.scratch, b) + KG_S_W});
#else
  float Pr[KM_N][KM_N], q[KM_N];
  sweep(bl, zeta, up, km::GramSink(a.op, up, sq, sq_step, Pr, q));
  const float obj = hand_over(Pr, q, LaneTerm{a.q0 ? a.q0 + bl : nullptr, B},
                              kl::scratch_row(a.scratch, b));
  if (live) a.obj[b] = obj;
#endif
}

// The solve launch's lanes: each lane's u_prev, x0 and obj (from the
// sweep launch; the wide builds form it in the solve) into its lane
// region; its pass QP; x (and the wide builds' obj) out, coalesced over
// the lanes.
template <class Args>
struct OnePassLanes {
  const Args& a;
  __device__ __forceinline__ void load(float*, float* H, long long bl,
                                       int) const {
#pragma unroll
    for (int j = 0; j < KM_M; ++j) H[KG_H_UP + j] = a.up[j * a.B + bl];
#pragma unroll
    for (int i = 0; i < KM_N; ++i) H[KG_L_X + i] = a.x0[i * a.B + bl];
#ifndef KG_S_W
    H[KG_L_OBJ] = a.obj[bl];
#endif
  }
  __device__ __forceinline__ void solve(const kg::Shared& sh, float* sm,
                                        int ql, int grp, int g) const {
    const long long b = (long long)blockIdx.x * KG_LANES + ql;
    const long long bl = b < a.B ? b : a.B - 1;
    solve_lane(a, sh, sm, ql, grp, g, true, a.slack_floor,
               LaneTerm{a.q0 ? a.q0 + bl : nullptr, a.B},
               kl::LaneDuals{a.lam0, a.B});
  }
  __device__ __forceinline__ void store(const float* H, long long b) const {
#pragma unroll
    for (int i = 0; i < KM_N; ++i) a.x[i * a.B + b] = H[KG_L_X + i];
#ifdef KG_S_W
    a.obj[b] = H[KG_L_OBJ];
#endif
  }
};

template <class Args>
__device__ __forceinline__ void one_pass(const Args& a) {
  kl::solve_block(a.op.con, a.B, OnePassLanes<Args>{a});
}

}  // namespace kn
