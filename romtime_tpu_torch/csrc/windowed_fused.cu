// Fused windowed serving sweep (kernel K1) for Hopper (sm_90a).
//
// Replaces romtime_tpu/ops/pallas_online.py::_windowed_fused_kernel
// (the Pallas TPU kernel behind online_sweep_windowed_fused): the whole
// W-window BDF-2 trajectory of a μ batch in one launch, double-f32 (dd)
// state carry, dd boundary transfers, merged solve-matrix product,
// θ-factored residual, quadratic-form trilinear term, pivot-free LU with
// optional paired-LU reuse ("sub1": leader factorizes, followers
// substitute and refine once), probes per step.
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
//   TL is the largest of 16/8/4/2/1 that fits 227 KB;
// - block-wide phases (KN, quadratic form, residual) give each thread
//   output entries and keep the TL lanes in registers, so every constant
//   read from global memory/L2 is reused TL times; per-window constants
//   (Bmk for 50 windows is ~15 MB) stay resident in the 50 MB L2;
// - per-lane phases (predictor, LU, substitution, dd update, probes) run
//   one warp per lane, one row per thread;
// - plain FP32 FMAs, no tensor cores (no TF32 anywhere).
// The dd transformations (TwoSum, TwoProduct, the dd matvec) use the
// __fadd_rn/__fmul_rn intrinsics, which nvcc never contracts into FMAs;
// TwoProduct's error term is fmaf(a, b, -p).

#include <cuda_runtime.h>

namespace {

constexpr int PROBE_P = 8;
constexpr int MAX_ROWS = 2;   // rows per thread in per-lane phases (NP ≤ 64)
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float ap = __fsub_rn(s, b);
  const float bp = __fsub_rn(s, ap);
  e = __fadd_rn(__fsub_rn(a, ap), __fsub_rn(b, bp));
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = fmaf(a, b, -p);
}

__device__ __forceinline__ void dd_add(float& ah, float& al, float bh, float bl) {
  float sh, se;
  two_sum(ah, bh, sh, se);
  two_sum(sh, __fadd_rn(__fadd_rn(se, al), bl), ah, al);
}

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
  float* probes;       // (nt, PROBE_P, B)
  float* state;        // (4, NP, B)
  int W, width, period, NP, B, km8, kk8, kf8, km, kk, with_tri, bdf2, group;
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

template <int TL>
__global__ void __launch_bounds__(TL * 32)
windowed_fused_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NP = p.NP, B = p.B;
  const int NP2 = NP * NP, lda = NP + 1, mat = NP * lda;
  const int kmk8 = p.km8 + p.kk8;
  const int K8 = kmk8 + p.kf8 + PROBE_P;
  const int kfold = kmk8 + (p.with_tri ? NP : 0);
  const int off_f = kmk8, off_g = kmk8 + p.kf8;

  float* F = smem;                    // TL × mat: KN / leader's LU factors
  float* Kc = F + TL * mat;           // TL × mat: follower's own KN
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
  float* trip = rv + TL * NP;
  float* rhs = trip + TL * NP;        // kfold × TL
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
  }
  if (li == 0) dtb0[l] = __fmul_rn(p.dt, p.b0[glc]);
  __syncthreads();

  for (int w = 0; w < p.W; ++w) {
    // ---- window boundary: dd transfer of both registers through T_w ----
    {
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
    }
    const float* Bmk = p.Bmk + (size_t)w * kfold * NP2;
    const float* BmF = p.BmF + (size_t)w * NP * p.km * NP;
    const float* BkF = p.BkF + (size_t)w * NP * p.kk * NP;
    const float* Bf = p.Bf + (size_t)w * p.kf8 * NP;
    const float* TQ = p.TQ + (size_t)w * NP * NP2;
    const float* VE = p.VE + (size_t)w * PROBE_P * NP;

    for (int s = 0; s < p.width; ++s) {
      const int step = w * p.width + s;
      const int role = step_role(s % p.period, p.period, p.group);
      const float* th = p.TH + (size_t)step * K8 * B;
      const bool first = !p.bdf2 || step == 0;
      const float bdf = first ? 1.0f : 1.5f;

      // ---- A (warp per lane): dd predictor + history difference, rhs ----
      for (int i = li; i < NP; i += 32) {
        const int o = l * NP + i;
        if (first) {
          ph[o] = uh[o];
          pl[o] = ul[o];
          dv[o] = 0.f;
        } else {
          float a, e, b, c;
          two_sum(__fmul_rn(2.f, uh[o]), -u1h[o], a, e);
          const float plo =
              __fadd_rn(e, __fsub_rn(__fmul_rn(2.f, ul[o]), u1l[o]));
          two_sum(a, plo, b, c);
          ph[o] = b;
          pl[o] = c;
          float dh, de;
          two_sum(u1h[o], -uh[o], dh, de);
          dv[o] = __fadd_rn(dh, __fadd_rn(de, __fsub_rn(u1l[o], ul[o])));
        }
      }
      for (int k = li; k < kmk8; k += 32)
        rhs[k * TL + l] = __fmul_rn(__ldg(&th[k * B + glc]),
                                    k < p.km8 ? bdf : 1.0f);
      __syncwarp();
      if (p.with_tri)
        for (int j = li; j < NP; j += 32)
          rhs[(kmk8 + j) * TL + l] = __fmul_rn(ph[l * NP + j], dtb0[l]);
      __syncthreads();

      // ---- B (block): solve matrix KN = Bmk·rhs, quadratic form ----
      {
        float* dst = role == 2 ? Kc : F;
        for (int ij = tid; ij < NP2; ij += nthreads) {
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

      // ---- D (warp per lane): solve KN·δ = r0 ----
      {
        float* A = F + l * mat;
        float* x = xv + l * NP;
        for (int i = li; i < NP; i += 32) x[i] = r0[l * NP + i];
        __syncwarp();
        if (role != 2) lu_factor(A, NP, lda, li);
        lu_solve(A, NP, lda, x, li);
        if (role == 2) {
          // One refinement against this step's own KN.
          const float* K = Kc + l * mat;
          float* rr = rv + l * NP;
          for (int i = li; i < NP; i += 32) {
            float acc = 0.f;
            for (int j = 0; j < NP; ++j) acc = fmaf(K[i * lda + j], x[j], acc);
            rr[i] = __fsub_rn(r0[l * NP + i], acc);
          }
          __syncwarp();
          lu_solve(A, NP, lda, rr, li);
          for (int i = li; i < NP; i += 32) x[i] = __fadd_rn(x[i], rr[i]);
          __syncwarp();
        }

        // ---- E: u = pred ⊕ δ (dd add), shift history, probes ----
        for (int i = li; i < NP; i += 32) {
          const int o = l * NP + i;
          float s1, e1, nh, nl;
          two_sum(ph[o], x[i], s1, e1);
          two_sum(s1, __fadd_rn(e1, pl[o]), nh, nl);
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

size_t smem_bytes(int TL, int NP, int kfold) {
  const size_t mat = (size_t)NP * (NP + 1);
  return sizeof(float) * (2 * TL * mat + 11 * (size_t)TL * NP
                          + (size_t)kfold * TL + TL);
}

template <int TL>
cudaError_t launch(const Params& p, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      windowed_fused_kernel<TL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int grid = (p.B + TL - 1) / TL;
  windowed_fused_kernel<TL><<<grid, TL * 32, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// The lane tile is the largest of 16/8/4/2/1 whose shared memory fits.
int romtime_windowed_fused(const float* TH, const float* Bmk, const float* BmF,
                           const float* BkF, const float* Bf, const float* TQ,
                           const float* VE, const float* Tp, const float* b0,
                           const float* state0, float* probes, float* state,
                           int W, int width, int period, int NP, int B,
                           int km8, int kk8, int kf8, int km, int kk,
                           int with_tri, int bdf2, int group, float dt,
                           void* stream) {
  Params p{TH, Bmk, BmF, BkF, Bf, TQ, VE, Tp, b0, state0, probes, state,
           W, width, period, NP, B, km8, kk8, kf8, km, kk, with_tri, bdf2,
           group, dt};
  if (NP > 32 * MAX_ROWS || NP % 8 != 0 || B < 1) return (int)cudaErrorInvalidValue;
  const int kfold = km8 + kk8 + (with_tri ? NP : 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (smem_bytes(16, NP, kfold) <= SMEM_LIMIT) return launch<16>(p, smem_bytes(16, NP, kfold), s);
  if (smem_bytes(8, NP, kfold) <= SMEM_LIMIT) return launch<8>(p, smem_bytes(8, NP, kfold), s);
  if (smem_bytes(4, NP, kfold) <= SMEM_LIMIT) return launch<4>(p, smem_bytes(4, NP, kfold), s);
  if (smem_bytes(2, NP, kfold) <= SMEM_LIMIT) return launch<2>(p, smem_bytes(2, NP, kfold), s);
  return launch<1>(p, smem_bytes(1, NP, kfold), s);
}

const char* romtime_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
