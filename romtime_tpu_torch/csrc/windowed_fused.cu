// Fused windowed serving sweep (kernel K1) for Hopper (sm_90a).
//
// Replaces romtime_tpu/ops/pallas_online.py::_windowed_fused_kernel
// (the Pallas TPU kernel behind online_sweep_windowed_fused): the whole
// W-window BDF-2 trajectory of a μ batch in one launch, double-f32 (dd)
// state carry, dd boundary transfers, merged solve-matrix product,
// θ-factored residual, quadratic-form trilinear term, pivot-free LU with
// optional paired-LU reuse or, with solve_iters > 0, the per-window
// Richardson solve (_lanes_invert / _richardson_solve), probes per step.
//
// Paired-LU follower modes (`mode`, ops/windowed_fused.py PAIRED_MODES):
// the group leader factorizes its KN into the factor slot F; each
// follower builds its own KN into the second slot Kc and then
//   sub1   substitutes r0 with F and refines once against Kc;
//   warm1  starts from the previous step's δ and runs one round of
//          "residual against Kc, substitute with F"; warm2 runs two;
//   warmx  starts from 2·δₙ₋₁ − δₙ₋₂ and runs one round;
//   inv1/2 the leader builds KN into Kc, puts I into F and inverts by
//          Gauss-Jordan across the two slots (F = K⁻¹), δ = F·r0; its
//          followers run 2 (inv1) or 3 (inv2) Richardson iterations with
//          F from a cold start.
// Under these modes every step keeps its δ (and, under warmx, δₙ₋₂ in one
// more TL×NP vector); under the warm modes and the Richardson solve δ
// crosses a window boundary through T_w as a plain f32 matvec. The modes
// other than sub1 are compiled into their own instantiation (FOLLOW),
// chosen on the host: with their branches in the serving instantiation
// (sub1 and Richardson) that one ran 10-11% slower at 16 lanes a block
// and 5-6% at 8 on an H100 (chip_smoke.py against the parent kernel in
// one run), at the same register count and without spills.
//
// Ablations (`ablate`, ops/windowed_fused.py ABLATE_MODES; the cost
// ledger of romtime_tpu_torch/kernel_ledger.py) are a template
// parameter, so the serving instantiation carries none of their code.
// Each still reads what the reference's variant reads and writes probes
// and state: `empty` loads θ row 0 and the g rows, stores probes = g and
// steps u ← 0.99·u + θ₀ (no K̄); `no_dots` builds KN0 = Bmk·1 and
// fN0 = Bf·1 once per window and solves KN0·δ = fN0 every step (the LU
// refactorizes a copy, Richardson runs against K̄⁻¹); `no_solve` takes
// δ = r0 after building KN (and K̄ under Richardson); `no_boundary` skips
// every window transfer. Any ablation turns the paired LU off.
//
// What bounds it on this card: per step and lane, building the solve
// matrix KN = Bmk·rhs (NP²·kfold FMAs, kfold = km8+kk8+NP) and the
// quadratic form TQ·vec(pred⊗pred) (NP³ FMAs) — both streams of per-window
// constants that every lane of the batch reads — plus the NP³/3 LU.
// At 50x32/B=2048 that is ~1e5 FMAs per lane-step and ~360 KB of
// constants per step for each tile of lanes.
//
// First design (simple and right first):
// - one thread block per tile of TL lanes (μ); the W×width step loop runs
//   inside the block, so the state never leaves shared memory;
// - KN and the leader's LU factors live in shared memory (NP×(NP+1)
//   floats per lane each, padded rows for conflict-free column access);
//   TL is the largest of 16/8/4 that fits 227 KB (4 always fits NP ≤ 64);
// - block-wide phases (KN, quadratic form, residual) give each thread
//   output entries and keep the TL lanes in registers, so every constant
//   read from global memory/L2 is reused TL times; per-window constants
//   (Bmk for 50 windows is ~15 MB) stay resident in the 50 MB L2;
// - per-lane phases (predictor, LU, substitution, dd update, probes) run
//   one warp per lane, one row per thread;
// - Richardson (solve_iters > 0): at each window start the block builds
//   K̄ = Bmk·[THbar_w; dt·b0·u] with the same block phase as KN, into the
//   follower's matrix slot, and each warp inverts its lane's K̄ in place
//   by Gauss-Jordan on [K̄ | I] with the identity in the factor slot, which
//   then holds K̄⁻¹ for the window. Each step writes its KN into the
//   follower slot and runs solve_iters pairs of row-per-thread matvecs
//   (δ ← δ + K̄⁻¹(r0 − KN·δ)) from the previous step's δ;
// - plain FP32 FMAs, no tensor cores (no TF32 anywhere).
// The dd transformations (TwoSum, TwoProduct, the dd matvec; csrc/dd.cuh)
// use the __fadd_rn/__fmul_rn intrinsics, which nvcc never contracts into
// FMAs; TwoProduct's error term is fmaf(a, b, -p).

#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int PROBE_P = 8;
constexpr int MAX_ROWS = 2;   // rows per thread in per-lane phases (NP ≤ 64)
constexpr size_t SMEM_LIMIT = 232448;

// Follower modes, in ops/windowed_fused.py PAIRED_MODES order.
enum Mode { SUB1 = 0, WARM1, WARM2, WARMX, INV1, INV2 };
// Ablations: 0 and then ops/windowed_fused.py ABLATE_MODES order.
enum Ablate { NONE = 0, EMPTY, NO_DOTS, NO_SOLVE, NO_BOUNDARY };

// Row i of the dd matvec T·(xh + xl) (ops/compensated.py dd_matvec):
// 8-column chunks of exact products reduced by a pairwise dd tree.
__device__ void dd_matvec_row(const float* __restrict__ T, int NP, int i,
                              const float* xh, const float* xl,
                              float& out_h, float& out_l) {
  float acc_h = 0.f, acc_l = 0.f;
  for (int c0 = 0; c0 < NP; c0 += 8) {
    float ph[8], pl[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float t = __ldg(&T[i * NP + c0 + c]);
      float e;
      two_prod(t, xh[c0 + c], ph[c], e);
      pl[c] = __fadd_rn(e, __fmul_rn(t, xl[c0 + c]));
    }
#pragma unroll
    for (int h = 4; h >= 1; h >>= 1) {
#pragma unroll
      for (int q = 0; q < h; ++q) dd_add(ph[q], pl[q], ph[q + h], pl[q + h]);
    }
    dd_add(acc_h, acc_l, ph[0], pl[0]);
  }
  two_sum(acc_h, acc_l, out_h, out_l);
}

// Plain f32 row i of T·x (the δ transfer: it seeds an iteration).
__device__ __forceinline__ float matvec_row(const float* __restrict__ T,
                                            int NP, int i, const float* x) {
  float acc = 0.f;
  for (int j = 0; j < NP; ++j) acc = fmaf(__ldg(&T[i * NP + j]), x[j], acc);
  return acc;
}

struct Params {
  const float* TH;     // (nt, K8, B)
  const float* Bmk;    // (W, kfold, NP²)
  const float* BmF;    // (W, NP, km·NP)
  const float* BkF;    // (W, NP, kk·NP)
  const float* Bf;     // (W, kf8, NP)
  const float* TQ;     // (W, NP, NP²)
  const float* VE;     // (W, PROBE_P, NP)
  const float* Tp;     // (W, NP, NP)
  const float* b0;     // (1, B)
  const float* state0; // (4, NP, B)
  const float* THbar;  // (W, km8 + kk8, B), read only with solve_iters > 0
  float* probes;       // (nt, PROBE_P, B)
  float* state;        // (4, NP, B)
  int W, width, period, NP, B, km8, kk8, kf8, km, kk, with_tri, bdf2, group,
      mode, solve_iters;
  float dt;
};

// Solve role of step s of a period (ops/windowed_fused.py step_roles):
// 0 = full LU, 1 = group leader (factorize, keep), 2 = follower.
__device__ __forceinline__ int step_role(int s, int period, int group) {
  if (group < 2) return 0;
  const int lead = period < 2 ? period : 2;
  const int q = s - lead;
  if (q < 0 || q >= ((period - lead) / group) * group) return 0;
  return (q % group) == 0 ? 1 : 2;
}

// Pivot-free right-looking LU in place (unit L below, U on and above the
// diagonal), one warp per lane matrix, thread li owning rows li, li+32.
__device__ void lu_factor(float* A, int NP, int lda, int li) {
  for (int k = 0; k < NP; ++k) {
    const float inv = 1.0f / A[k * lda + k];
    for (int i = li; i < NP; i += 32) {
      if (i > k) {
        const float l = A[i * lda + k] * inv;
        A[i * lda + k] = l;
        for (int j = k + 1; j < NP; ++j)
          A[i * lda + j] = fmaf(-l, A[k * lda + j], A[i * lda + j]);
      }
    }
    __syncwarp();
  }
}

// x ← (LU)⁻¹ x in place.
__device__ void lu_solve(const float* A, int NP, int lda, float* x, int li) {
  for (int k = 0; k < NP; ++k) {
    const float xk = x[k];
    for (int i = li; i < NP; i += 32)
      if (i > k) x[i] = fmaf(-A[i * lda + k], xk, x[i]);
    __syncwarp();
  }
  for (int k = NP - 1; k >= 0; --k) {
    const float xk = x[k] / A[k * lda + k];
    __syncwarp();
    for (int i = li; i < NP; i += 32) {
      if (i < k) x[i] = fmaf(-A[i * lda + k], xk, x[i]);
      else if (i == k) x[i] = xk;
    }
    __syncwarp();
  }
}

// rr = r − K·x, row per thread (one warp per lane).
__device__ void residual(const float* K, const float* x, const float* r,
                         float* rr, int NP, int lda, int li) {
  for (int i = li; i < NP; i += 32) {
    float acc = 0.f;
    for (int j = 0; j < NP; ++j) acc = fmaf(K[i * lda + j], x[j], acc);
    rr[i] = __fsub_rn(r[i], acc);
  }
}

// out = A·v, row per thread (one warp per lane).
__device__ void matvec(const float* A, const float* v, float* out, int NP,
                       int lda, int li) {
  for (int i = li; i < NP; i += 32) {
    float acc = 0.f;
    for (int j = 0; j < NP; ++j) acc = fmaf(A[i * lda + j], v[j], acc);
    out[i] = acc;
  }
}

// `rounds` Richardson iterations x ← x + P·(r − K·x) from the x given
// (ops/windowed_fused.py richardson_solve); rr is scratch.
__device__ void richardson_rounds(const float* K, const float* P,
                                  const float* r, float* x, float* rr,
                                  int rounds, int NP, int lda, int li) {
  for (int it = 0; it < rounds; ++it) {
    residual(K, x, r, rr, NP, lda, li);
    __syncwarp();
    for (int i = li; i < NP; i += 32) {
      float acc = 0.f;
      for (int j = 0; j < NP; ++j) acc = fmaf(P[i * lda + j], rr[j], acc);
      x[i] = __fadd_rn(x[i], acc);
    }
    __syncwarp();
  }
}

// `rounds` refinements x ← x + (LU)⁻¹(r − K·x) with saved factors A.
__device__ void lu_rounds(const float* K, const float* A, const float* r,
                          float* x, float* rr, int rounds, int NP, int lda,
                          int li) {
  for (int it = 0; it < rounds; ++it) {
    residual(K, x, r, rr, NP, lda, li);
    __syncwarp();
    lu_solve(A, NP, lda, rr, li);
    for (int i = li; i < NP; i += 32) x[i] = __fadd_rn(x[i], rr[i]);
    __syncwarp();
  }
}

// dst[t] = Bmk·rhs[:, t] for the TL lanes of the tile (block phase): the
// solve matrix of each lane, each thread owning whole entries (i, j) and
// keeping the TL lanes in registers.
template <int TL>
__device__ void build_matrix(const float* __restrict__ Bmk, const float* rhs,
                             float* dst, int NP, int kfold, int tid) {
  const int NP2 = NP * NP, lda = NP + 1, mat = NP * lda;
  for (int ij = tid; ij < NP2; ij += TL * 32) {
    float acc[TL];
#pragma unroll
    for (int t = 0; t < TL; ++t) acc[t] = 0.f;
    for (int k = 0; k < kfold; ++k) {
      const float b = __ldg(&Bmk[(size_t)k * NP2 + ij]);
#pragma unroll
      for (int t = 0; t < TL; ++t) acc[t] = fmaf(b, rhs[k * TL + t], acc[t]);
    }
    const int i = ij / NP, j = ij - i * NP;
#pragma unroll
    for (int t = 0; t < TL; ++t) dst[t * mat + i * lda + j] = acc[t];
  }
}

// [A | R] ← Gauss-Jordan over all NP pivots, no pivoting, one warp per
// lane (thread li owning rows li, li+32): with R = I on entry, R = A⁻¹ on
// exit (ops/windowed_fused.py lanes_invert: every row but k loses
// A[i,k]·(row k · 1/A[k,k]), then row k is scaled).
__device__ void gj_invert(float* A, float* R, int NP, int lda, int li) {
  for (int k = 0; k < NP; ++k) {
    const float inv = 1.0f / A[k * lda + k];
    for (int i = li; i < NP; i += 32) {
      if (i == k) continue;
      const float c = A[i * lda + k];
      for (int j = 0; j < NP; ++j)
        A[i * lda + j] = fmaf(-c, __fmul_rn(A[k * lda + j], inv), A[i * lda + j]);
      for (int j = 0; j < NP; ++j)
        R[i * lda + j] = fmaf(-c, __fmul_rn(R[k * lda + j], inv), R[i * lda + j]);
    }
    __syncwarp();
    if ((k & 31) == li) {
      for (int j = 0; j < NP; ++j) {
        A[k * lda + j] = __fmul_rn(A[k * lda + j], inv);
        R[k * lda + j] = __fmul_rn(R[k * lda + j], inv);
      }
    }
    __syncwarp();
  }
}

// R ← I (one warp per lane).
__device__ void set_identity(float* R, int NP, int lda, int li) {
  for (int ij = li; ij < NP * NP; ij += 32) {
    const int i = ij / NP, j = ij - i * NP;
    R[i * lda + j] = i == j ? 1.f : 0.f;
  }
}

// FOLLOW: a paired-LU schedule whose followers run a mode other than sub1
// (chosen on the host); the serving path (sub1, Richardson) is compiled
// without that code.
template <int TL, int ABL, bool FOLLOW>
__global__ void __launch_bounds__(TL * 32)
windowed_fused_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NP = p.NP, B = p.B;
  const int NP2 = NP * NP, lda = NP + 1, mat = NP * lda;
  const int kmk8 = p.km8 + p.kk8;
  const int K8 = kmk8 + p.kf8 + PROBE_P;
  const int kfold = kmk8 + (p.with_tri ? NP : 0);
  const int off_f = kmk8, off_g = kmk8 + p.kf8;
  const bool inv_mode = FOLLOW && (p.mode == INV1 || p.mode == INV2);
  const bool track_d2 = FOLLOW && p.mode == WARMX;
  // δ crosses a window boundary where a later step starts from it.
  const bool carry_delta = p.solve_iters > 0 || (FOLLOW && !inv_mode);

  float* F = smem;                    // TL × mat: KN / LU factors / K⁻¹
  float* Kc = F + TL * mat;           // TL × mat: follower's own KN / K̄
  float* vec = Kc + TL * mat;
  float* uh = vec;                    // each TL × NP
  float* ul = uh + TL * NP;
  float* u1h = ul + TL * NP;
  float* u1l = u1h + TL * NP;
  float* ph = u1l + TL * NP;
  float* pl = ph + TL * NP;
  float* dv = pl + TL * NP;
  float* r0 = dv + TL * NP;
  float* xv = r0 + TL * NP;
  float* rv = xv + TL * NP;
  float* trip = rv + TL * NP;         // trilinear term (fN0 under no_dots)
  float* dp = trip + TL * NP;         // previous step's δ
  float* dp2 = dp + TL * NP;          // δₙ₋₂ (warmx groups only)
  float* rhs = dp2 + (track_d2 ? TL * NP : 0);  // kfold × TL
  float* dtb0 = rhs + kfold * TL;     // TL

  const int tid = threadIdx.x;
  const int nthreads = TL * 32;
  const int l = tid >> 5;             // this warp's lane in the tile
  const int li = tid & 31;
  const int gl = static_cast<int>(blockIdx.x) * TL + l;
  const bool valid = gl < B;
  const int glc = valid ? gl : B - 1;

  // Load the dd carry.
  for (int i = li; i < NP; i += 32) {
    uh[l * NP + i] = p.state0[(0 * NP + i) * B + glc];
    ul[l * NP + i] = p.state0[(1 * NP + i) * B + glc];
    u1h[l * NP + i] = p.state0[(2 * NP + i) * B + glc];
    u1l[l * NP + i] = p.state0[(3 * NP + i) * B + glc];
    dp[l * NP + i] = 0.f;
    if (track_d2) dp2[l * NP + i] = 0.f;
  }
  if (li == 0) dtb0[l] = __fmul_rn(p.dt, p.b0[glc]);
  __syncthreads();

  for (int w = 0; w < p.W; ++w) {
    // ---- window boundary: dd transfer of both registers through T_w,
    //      plain transfer of the carried δ's ----
    if constexpr (ABL != NO_BOUNDARY) {
      const float* T = p.Tp + (size_t)w * NP2;
      float oh[MAX_ROWS], ol[MAX_ROWS], o1h[MAX_ROWS], o1l[MAX_ROWS];
      int r = 0;
      for (int i = li; i < NP; i += 32, ++r) {
        dd_matvec_row(T, NP, i, uh + l * NP, ul + l * NP, oh[r], ol[r]);
        dd_matvec_row(T, NP, i, u1h + l * NP, u1l + l * NP, o1h[r], o1l[r]);
      }
      __syncwarp();
      r = 0;
      for (int i = li; i < NP; i += 32, ++r) {
        uh[l * NP + i] = oh[r];
        ul[l * NP + i] = ol[r];
        u1h[l * NP + i] = o1h[r];
        u1l[l * NP + i] = o1l[r];
      }
      __syncthreads();
      if (carry_delta) {
        float dn[MAX_ROWS], dn2[MAX_ROWS];
        r = 0;
        for (int i = li; i < NP; i += 32, ++r) {
          dn[r] = matvec_row(T, NP, i, dp + l * NP);
          if (track_d2) dn2[r] = matvec_row(T, NP, i, dp2 + l * NP);
        }
        __syncwarp();
        r = 0;
        for (int i = li; i < NP; i += 32, ++r) {
          dp[l * NP + i] = dn[r];
          if (track_d2) dp2[l * NP + i] = dn2[r];
        }
      }
    }
    const float* Bmk = p.Bmk + (size_t)w * kfold * NP2;
    const float* BmF = p.BmF + (size_t)w * NP * p.km * NP;
    const float* BkF = p.BkF + (size_t)w * NP * p.kk * NP;
    const float* Bf = p.Bf + (size_t)w * p.kf8 * NP;
    const float* TQ = p.TQ + (size_t)w * NP * NP2;
    const float* VE = p.VE + (size_t)w * PROBE_P * NP;

    // ---- Richardson window start: K̄ → Kc, K̄⁻¹ → F ----
    if (ABL != EMPTY && p.solve_iters > 0) {
      const float* thb = p.THbar + (size_t)w * kmk8 * B;
      for (int k = li; k < kmk8; k += 32)
        rhs[k * TL + l] = __ldg(&thb[(size_t)k * B + glc]);
      if (p.with_tri)
        for (int j = li; j < NP; j += 32)
          rhs[(kmk8 + j) * TL + l] = __fmul_rn(uh[l * NP + j], dtb0[l]);
      set_identity(F + l * mat, NP, lda, li);
      __syncthreads();
      build_matrix<TL>(Bmk, rhs, Kc, NP, kfold, tid);
      __syncthreads();
      gj_invert(Kc + l * mat, F + l * mat, NP, lda, li);
      __syncthreads();
    }
    // ---- no_dots window start: KN0 = Bmk·1 → Kc, fN0 = Bf·1 → trip ----
    if constexpr (ABL == NO_DOTS) {
      for (int k = li; k < kfold; k += 32) rhs[k * TL + l] = 1.f;
      for (int n = li; n < NP; n += 32) {
        float acc = 0.f;
        for (int k = 0; k < p.kf8; ++k) acc = fmaf(__ldg(&Bf[k * NP + n]), 1.f, acc);
        trip[l * NP + n] = acc;
      }
      __syncthreads();
      build_matrix<TL>(Bmk, rhs, Kc, NP, kfold, tid);
      __syncthreads();
    }

    for (int s = 0; s < p.width; ++s) {
      const int step = w * p.width + s;
      const int role = step_role(s % p.period, p.period, p.group);
      const float* th = p.TH + (size_t)step * K8 * B;
      const bool first = !p.bdf2 || step == 0;
      const float bdf = first ? 1.0f : 1.5f;

      if constexpr (ABL == EMPTY) {
        // Loop, θ reads and probe stores only: u ← 0.99·u + θ row 0.
        const float th0 = __ldg(&th[glc]);
        for (int i = li; i < NP; i += 32) {
          const int o = l * NP + i;
          u1h[o] = uh[o];
          uh[o] = __fadd_rn(__fmul_rn(uh[o], 0.99f), th0);
        }
        if (li < PROBE_P && valid)
          p.probes[((size_t)step * PROBE_P + li) * B + gl] =
              __ldg(&th[(off_g + li) * B + glc]);
        __syncthreads();
        continue;
      }

      // ---- A (warp per lane): dd predictor + history difference, rhs ----
      for (int i = li; i < NP; i += 32) {
        const int o = l * NP + i;
        if (first) {
          ph[o] = uh[o];
          pl[o] = ul[o];
          dv[o] = 0.f;
        } else {
          dd_predict(uh[o], ul[o], u1h[o], u1l[o], ph[o], pl[o], dv[o]);
        }
      }
      if constexpr (ABL != NO_DOTS) {
        for (int k = li; k < kmk8; k += 32)
          rhs[k * TL + l] = __fmul_rn(__ldg(&th[k * B + glc]),
                                      k < p.km8 ? bdf : 1.0f);
        __syncwarp();
        if (p.with_tri)
          for (int j = li; j < NP; j += 32)
            rhs[(kmk8 + j) * TL + l] = __fmul_rn(ph[l * NP + j], dtb0[l]);
      }
      __syncthreads();

      if constexpr (ABL == NO_DOTS) {
        // The LU refactorizes a copy of KN0 every step.
        if (p.solve_iters == 0) {
          for (int ij = li; ij < NP2; ij += 32) {
            const int i = ij / NP, j = ij - i * NP;
            F[l * mat + i * lda + j] = Kc[l * mat + i * lda + j];
          }
        }
        __syncwarp();
      } else {
        // ---- B (block): solve matrix KN = Bmk·rhs, quadratic form ----
        const bool own_slot =
            role == 2 || p.solve_iters > 0 || (role == 1 && inv_mode);
        build_matrix<TL>(Bmk, rhs, own_slot ? Kc : F, NP, kfold, tid);
        if (p.with_tri) {
          // trip[i] = (Σ_jk TQ[i, jk]·pred_j·pred_k)·dt·b0, a warp per row.
          for (int i = l; i < NP; i += TL) {
            float acc[TL];
#pragma unroll
            for (int t = 0; t < TL; ++t) acc[t] = 0.f;
            for (int jk = li; jk < NP2; jk += 32) {
              const float q = __ldg(&TQ[(size_t)i * NP2 + jk]);
              const int j = jk / NP, k = jk - j * NP;
#pragma unroll
              for (int t = 0; t < TL; ++t)
                acc[t] = fmaf(q, __fmul_rn(ph[t * NP + j], ph[t * NP + k]), acc[t]);
            }
#pragma unroll
            for (int t = 0; t < TL; ++t) {
              float v = acc[t];
              for (int off = 16; off > 0; off >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
              if (li == 0) trip[t * NP + i] = __fmul_rn(v, dtb0[t]);
            }
          }
        }
        __syncthreads();

        // ---- C (block): r0 = Σθm·(BmF·d) + fN − Σθk·(BkF·pred) − trip ----
        for (int idx = tid; idx < TL * NP; idx += nthreads) {
          const int t = idx / NP, n = idx - t * NP;
          const int gt = min(static_cast<int>(blockIdx.x) * TL + t, B - 1);
          const float* d_t = dv + t * NP;
          const float* p_t = ph + t * NP;
          float mnd = 0.f, fn = 0.f, klp = 0.f;
          for (int k = 0; k < p.km; ++k) {
            float acc = 0.f;
            for (int j = 0; j < NP; ++j)
              acc = fmaf(__ldg(&BmF[(size_t)j * p.km * NP + k * NP + n]), d_t[j], acc);
            mnd = fmaf(acc, __ldg(&th[k * B + gt]), mnd);
          }
          for (int k = 0; k < p.kf8; ++k)
            fn = fmaf(__ldg(&Bf[k * NP + n]), __ldg(&th[(off_f + k) * B + gt]), fn);
          for (int k = 0; k < p.kk; ++k) {
            float acc = 0.f;
            for (int j = 0; j < NP; ++j)
              acc = fmaf(__ldg(&BkF[(size_t)j * p.kk * NP + k * NP + n]), p_t[j], acc);
            klp = fmaf(acc, __ldg(&th[(p.km8 + k) * B + gt]), klp);
          }
          const float tr = p.with_tri ? trip[t * NP + n] : 0.f;
          r0[t * NP + n] = __fsub_rn(__fsub_rn(__fadd_rn(mnd, fn), klp), tr);
        }
        __syncthreads();
      }

      // ---- D (warp per lane): solve KN·δ = r0 (KN0·δ = fN0) ----
      {
        float* A = F + l * mat;
        float* x = xv + l * NP;
        float* K = Kc + l * mat;
        float* rr = rv + l * NP;
        const float* r = (ABL == NO_DOTS ? trip : r0) + l * NP;
        float* d = dp + l * NP;
        float* d2 = dp2 + l * NP;
        if (ABL == NO_SOLVE) {
          for (int i = li; i < NP; i += 32) x[i] = r[i];
        } else if (p.solve_iters > 0) {
          // Richardson from the previous δ: δ ← δ + K̄⁻¹(r0 − KN·δ).
          for (int i = li; i < NP; i += 32) x[i] = d[i];
          __syncwarp();
          richardson_rounds(K, A, r, x, rr, p.solve_iters, NP, lda, li);
          for (int i = li; i < NP; i += 32) d[i] = x[i];
        } else if constexpr (FOLLOW) {
          if (role == 2 && inv_mode) {
            // Cold Richardson with the leader's K⁻¹: 2 (inv1) or 3 (inv2).
            matvec(A, r, x, NP, lda, li);
            __syncwarp();
            richardson_rounds(K, A, r, x, rr, p.mode == INV1 ? 1 : 2, NP,
                              lda, li);
          } else if (role == 2) {
            // warm1/warm2 from δₙ₋₁, warmx from 2·δₙ₋₁ − δₙ₋₂.
            for (int i = li; i < NP; i += 32)
              x[i] = p.mode == WARMX ? __fsub_rn(__fmul_rn(2.f, d[i]), d2[i])
                                     : d[i];
            __syncwarp();
            lu_rounds(K, A, r, x, rr, p.mode == WARM2 ? 2 : 1, NP, lda, li);
          } else if (role == 1 && inv_mode) {
            // inv leader: F ← I, Gauss-Jordan on [KN | I] → F = K⁻¹,
            // δ = F·r0.
            set_identity(A, NP, lda, li);
            __syncwarp();
            gj_invert(K, A, NP, lda, li);
            matvec(A, r, x, NP, lda, li);
          } else {
            for (int i = li; i < NP; i += 32) x[i] = r[i];
            __syncwarp();
            lu_factor(A, NP, lda, li);
            lu_solve(A, NP, lda, x, li);
          }
          __syncwarp();
          // Every step keeps δ (and shifts δₙ₋₂) for a follower's start.
          for (int i = li; i < NP; i += 32) {
            if (track_d2) d2[i] = d[i];
            d[i] = x[i];
          }
        } else {
          for (int i = li; i < NP; i += 32) x[i] = r[i];
          __syncwarp();
          if (role != 2) lu_factor(A, NP, lda, li);
          lu_solve(A, NP, lda, x, li);
          // sub1 follower: one refinement against this step's own KN.
          if (role == 2) lu_rounds(K, A, r, x, rr, 1, NP, lda, li);
        }

        // ---- E: u = pred ⊕ δ (dd add), shift history, probes ----
        for (int i = li; i < NP; i += 32) {
          const int o = l * NP + i;
          float nh, nl;
          dd_add_small(ph[o], pl[o], x[i], nh, nl);
          u1h[o] = uh[o];
          u1l[o] = ul[o];
          uh[o] = nh;
          ul[o] = nl;
        }
        __syncwarp();
        if (li < PROBE_P) {
          float acc = 0.f;
          for (int j = 0; j < NP; ++j)
            acc = fmaf(__ldg(&VE[li * NP + j]), uh[l * NP + j], acc);
          const float g = __ldg(&th[(off_g + li) * B + glc]);
          if (valid) p.probes[((size_t)step * PROBE_P + li) * B + gl] = __fadd_rn(acc, g);
        }
      }
      __syncthreads();
    }
  }

  if (valid) {
    for (int i = li; i < NP; i += 32) {
      p.state[(0 * NP + i) * B + gl] = uh[l * NP + i];
      p.state[(1 * NP + i) * B + gl] = ul[l * NP + i];
      p.state[(2 * NP + i) * B + gl] = u1h[l * NP + i];
      p.state[(3 * NP + i) * B + gl] = u1l[l * NP + i];
    }
  }
}

size_t smem_bytes(int TL, int NP, int kfold, bool track_d2) {
  const size_t mat = (size_t)NP * (NP + 1);
  return sizeof(float) * (2 * TL * mat + (12 + track_d2) * (size_t)TL * NP
                          + (size_t)kfold * TL + TL);
}

template <int TL, int ABL, bool FOLLOW>
cudaError_t launch(const Params& p, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      windowed_fused_kernel<TL, ABL, FOLLOW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int grid = (p.B + TL - 1) / TL;
  windowed_fused_kernel<TL, ABL, FOLLOW><<<grid, TL * 32, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int TL>
cudaError_t launch_variant(const Params& p, int ablate, bool follow,
                           size_t bytes, cudaStream_t stream) {
  if (follow) return launch<TL, NONE, true>(p, bytes, stream);
  switch (ablate) {
    case NONE: return launch<TL, NONE, false>(p, bytes, stream);
    case EMPTY: return launch<TL, EMPTY, false>(p, bytes, stream);
    case NO_DOTS: return launch<TL, NO_DOTS, false>(p, bytes, stream);
    case NO_SOLVE: return launch<TL, NO_SOLVE, false>(p, bytes, stream);
    case NO_BOUNDARY: return launch<TL, NO_BOUNDARY, false>(p, bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// The lane tile is the largest of 16/8/4 whose shared memory fits.
int romtime_windowed_fused(const float* TH, const float* Bmk, const float* BmF,
                           const float* BkF, const float* Bf, const float* TQ,
                           const float* VE, const float* Tp, const float* b0,
                           const float* state0, const float* THbar,
                           float* probes, float* state,
                           int W, int width, int period, int NP, int B,
                           int km8, int kk8, int kf8, int km, int kk,
                           int with_tri, int bdf2, int group, int mode,
                           int solve_iters, int ablate, float dt,
                           void* stream) {
  // The Richardson solve and every ablation run without the paired LU.
  if (solve_iters > 0 || ablate != NONE) group = 0;
  Params p{TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0, THbar, probes,
           state, W, width, period, NP, B, km8, kk8, kf8, km, kk, with_tri,
           bdf2, group, mode, solve_iters, dt};
  if (NP > 32 * MAX_ROWS || NP % 8 != 0 || B < 1 || solve_iters < 0 ||
      mode < SUB1 || mode > INV2)
    return (int)cudaErrorInvalidValue;
  const int kfold = km8 + kk8 + (with_tri ? NP : 0);
  const bool follow = group >= 2 && mode != SUB1;
  const bool d2 = follow && mode == WARMX;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (smem_bytes(16, NP, kfold, d2) <= SMEM_LIMIT)
    return launch_variant<16>(p, ablate, follow, smem_bytes(16, NP, kfold, d2), s);
  if (smem_bytes(8, NP, kfold, d2) <= SMEM_LIMIT)
    return launch_variant<8>(p, ablate, follow, smem_bytes(8, NP, kfold, d2), s);
  if (smem_bytes(4, NP, kfold, d2) <= SMEM_LIMIT)
    return launch_variant<4>(p, ablate, follow, smem_bytes(4, NP, kfold, d2), s);
  return (int)cudaErrorInvalidValue;
}

const char* romtime_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
