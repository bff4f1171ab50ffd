// Residual-form serving sweeps K2 and K3 for Hopper (sm_90a).
//
// Replaces, in romtime_tpu/ops/pallas_online.py,
// - _sweep_kernel_v2 (K2, behind online_sweep_pallas_v2): per-step MN, KL
//   and fN read from materialized (nt, NP, NP, B) time tables;
// - _theta_sweep_kernel_v2 (K3, behind online_sweep_theta_pallas_v2):
//   MN = Bm·θm, KL = Bk·θk and fN = Bf·θf formed per step in the kernel.
// One kernel template serves both; the compile-time flag THETA picks where
// the step's operators come from. Each launch runs the steps of one window
// of the residual-form dd BDF step (_bdf_step_resid):
//
//   pred, d = dd BDF-2 predictor of the double-f32 carry (BDF-1 at global
//             step 0)
//   dtS  = KL + reshape(T0·pred)·dt·b0          (trilinear, optional)
//   KN   = bdf·MN + dtS
//   r0   = MN·d + fN − dtS·pred
//   KN·δ = r0   (pivot-free: Gauss-Jordan for N ≤ 20, blocked 8×8 LU above)
//   u    = pred ⊕ δ (dd add);  probes = VE·u + g
//
// The dd state comes in and goes out through global memory, so per-window
// launches chain; step0 (the launch's first global step) only selects
// BDF-1 at global step 0.
//
// What bounds it on this card:
// - K2 is bound by bytes: it streams MN and KL, 2·NP²·4 bytes per
//   lane-step (8 KB at NP=32), and does ~NP³ + 3·NP² FMAs plus the solve
//   on them: ~6 FLOP per byte, far below the ~20 at which the FP32 rate
//   would take over.
// - K3 is bound by operations: per lane-step NP²·(km8 + kk8) FMAs for the
//   operators, NP³ for the trilinear term and ~NP³/3 for the LU (~8.7e4 at
//   50x32), against (km8 + kk8 + kf8 + 8)·4 bytes of θ and probe streams.
// First design (simple and right first):
// - one thread block per tile of TL lanes (μ), one warp per lane; the
//   launch's steps run in order inside the block and the dd state stays in
//   shared memory;
// - operator phase (block-wide): each thread owns solve-matrix entries and
//   keeps the TL lanes in registers, so every read of the per-window
//   constants Bm, Bk and T0 (L2-resident) serves the whole tile; K2 reads
//   each lane's MN/KL entries once, straight from device memory. Those
//   reads are poorly coalesced: a warp's 32 threads take 32 rows B floats
//   apart, TL lanes each, so at TL = 2 a 32-byte sector carries 8 useful
//   bytes. How much of K2's distance from its byte bound this costs is not
//   measured; staging the step's tile through shared memory with threads
//   contiguous over lanes is the candidate repair;
// - residual phase (block-wide, a thread per lane and row) forms r0 and KN;
// - solve, dd update and probes: a warp per lane, a thread per row;
// - the tile TL is the largest of 16/8/4/2/1 that fits 227 KB of shared
//   memory and still gives every SM a block, so a small batch (K2's
//   regime) spreads over the card instead of idling most SMs;
// - plain FP32 FMAs, no tensor cores (no TF32 anywhere); dd arithmetic
//   through csrc/dd.cuh (__fadd_rn/__fmul_rn, TwoProduct's error by fmaf).

#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int PROBE_P = 8;
constexpr int MAX_ROWS = 2;   // rows per thread in per-lane phases (NP ≤ 64)
constexpr int LU_BS = 8;      // pivot block of the blocked LU
constexpr int GJ_MAX = 20;    // Gauss-Jordan up to this N, blocked LU above
constexpr size_t SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* MN;      // K2: (nt, NP, NP, B)
  const float* KL;      // K2: (nt, NP, NP, B)
  const float* fN;      // K2: (nt, NP, B)
  const float* THm;     // K3: (nt, km8, B)
  const float* THk;     // K3: (nt, kk8, B)
  const float* THf;     // K3: (nt, kf8, B)
  const float* Bm;      // K3: (NP², km8)
  const float* Bk;      // K3: (NP², kk8)
  const float* Bf;      // K3: (NP, kf8)
  const float* g;       // (nt, PROBE_P, B)
  const float* T0;      // (NP², NP)
  const float* VE;      // (PROBE_P, NP)
  const float* b0;      // (1, B)
  const float* state0;  // (4, NP, B)
  float* probes;        // (nt, PROBE_P, B)
  float* state;         // (4, NP, B)
  int nt, NP, B, km8, kk8, kf8, n_real, step0, with_tri, bdf2;
  float dt;
};

// Unrolled pivot-free Gauss-Jordan over the first n_real pivots
// (ops/windowed_fused.py _gauss_jordan), one warp per lane matrix, thread
// li owning rows li and li + 32. x holds r0 on entry and δ on exit.
__device__ void gj_solve(float* A, int NP, int lda, float* x, int n_real,
                         int li) {
  for (int k = 0; k < n_real; ++k) {
    const float inv = 1.0f / A[k * lda + k];
    const float bk = x[k] * inv;
    float c[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      const int i = li + 32 * r;
      c[r] = i < NP ? A[i * lda + k] : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      const int i = li + 32 * r;
      if (i < NP && i != k) {
        for (int j = k + 1; j < NP; ++j)
          A[i * lda + j] = fmaf(-c[r], A[k * lda + j] * inv, A[i * lda + j]);
        x[i] = fmaf(-c[r], bk, x[i]);
      }
    }
    __syncwarp();
    if ((k & 31) == li) {
      for (int j = k + 1; j < NP; ++j) A[k * lda + j] *= inv;
      x[k] = bk;
    }
    __syncwarp();
  }
}

// Blocked pivot-free LU with 8×8 pivot blocks (ops/windowed_fused.py
// lanes_solve_panels): per block, Jordan on [D | I | r] gives D⁻¹ and y,
// then the trailing matrix takes the rank-8 update C·D⁻¹·U; back
// substitution runs over the saved (D⁻¹, U) panels. D⁻¹ overwrites D in
// place. One warp per lane matrix; x holds r0 on entry and δ on exit.
__device__ void blocked_lu_solve(float* A, int NP, int lda, float* x, int li) {
  const int NB = NP / LU_BS;
  for (int jb = 0; jb < NB; ++jb) {
    const int o = jb * LU_BS;
    // Jordan on the augmented block, thread li < 8 holding its row.
    float a[2 * LU_BS + 1];
#pragma unroll
    for (int c = 0; c < 2 * LU_BS + 1; ++c) a[c] = 0.f;
    if (li < LU_BS) {
#pragma unroll
      for (int c = 0; c < LU_BS; ++c) {
        a[c] = A[(o + li) * lda + o + c];
        a[LU_BS + c] = c == li ? 1.f : 0.f;
      }
      a[2 * LU_BS] = x[o + li];
    }
#pragma unroll
    for (int i = 0; i < LU_BS; ++i) {
      const float inv = 1.0f / __shfl_sync(FULL, a[i], i);
      const float ci = a[i];
#pragma unroll
      for (int c = 0; c < 2 * LU_BS + 1; ++c) {
        const float rowc = __shfl_sync(FULL, a[c], i) * inv;
        a[c] = li == i ? rowc : fmaf(-ci, rowc, a[c]);
      }
    }
    if (li < LU_BS) {
#pragma unroll
      for (int c = 0; c < LU_BS; ++c) A[(o + li) * lda + o + c] = a[LU_BS + c];
      x[o + li] = a[2 * LU_BS];
    }
    __syncwarp();
    // Trailing update: A₂₂ −= (C·D⁻¹)·U, r₂ −= C·y.
    const int R = NP - o - LU_BS;
    for (int r = li; r < R; r += 32) {
      const int row = o + LU_BS + r;
      float Crow[LU_BS], CD[LU_BS];
#pragma unroll
      for (int k = 0; k < LU_BS; ++k) Crow[k] = A[row * lda + o + k];
#pragma unroll
      for (int c = 0; c < LU_BS; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < LU_BS; ++k)
          acc = fmaf(Crow[k], A[(o + k) * lda + o + c], acc);
        CD[c] = acc;
      }
      for (int j = o + LU_BS; j < NP; ++j) {
        float upd = 0.f;
#pragma unroll
        for (int i = 0; i < LU_BS; ++i)
          upd = fmaf(CD[i], A[(o + i) * lda + j], upd);
        A[row * lda + j] -= upd;
      }
      float updr = 0.f;
#pragma unroll
      for (int i = 0; i < LU_BS; ++i) updr = fmaf(Crow[i], x[o + i], updr);
      x[row] -= updr;
    }
    __syncwarp();
  }
  // Back substitution: x_b = y_b − D⁻¹_b·(U_b·x_{>b}).
  for (int jb = NB - 2; jb >= 0; --jb) {
    const int o = jb * LU_BS;
    float ux = 0.f;
    if (li < LU_BS)
      for (int j = o + LU_BS; j < NP; ++j)
        ux = fmaf(A[(o + li) * lda + j], x[j], ux);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < LU_BS; ++c) {
      const float uxc = __shfl_sync(FULL, ux, c);
      if (li < LU_BS) acc = fmaf(A[(o + li) * lda + o + c], uxc, acc);
    }
    if (li < LU_BS) x[o + li] -= acc;
    __syncwarp();
  }
}

template <bool THETA, int TL>
__global__ void __launch_bounds__(TL * 32)
resid_sweep_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NP = p.NP, B = p.B;
  const int NP2 = NP * NP, lda = NP + 1, mat = NP * lda;
  const int km8 = p.km8, kk8 = p.kk8, kf8 = p.kf8;
  const int kth = THETA ? km8 + kk8 + kf8 : 0;

  float* Mm = smem;                 // TL × mat: MN
  float* F = Mm + TL * mat;         // TL × mat: dtS, then KN, then its LU
  float* uh = F + TL * mat;         // each TL × NP
  float* ul = uh + TL * NP;
  float* u1h = ul + TL * NP;
  float* u1l = u1h + TL * NP;
  float* ph = u1l + TL * NP;
  float* pl = ph + TL * NP;
  float* dv = pl + TL * NP;
  float* xv = dv + TL * NP;         // r0, then δ
  float* th = xv + TL * NP;         // kth × TL: the step's θm | θk | θf (K3)
  float* dtb0 = th + kth * TL;      // TL

  const int tid = threadIdx.x;
  const int nthreads = TL * 32;
  const int l = tid >> 5;           // this warp's lane in the tile
  const int li = tid & 31;
  const int base = static_cast<int>(blockIdx.x) * TL;
  const int gl = base + l;
  const bool valid = gl < B;
  const int glc = valid ? gl : B - 1;

  for (int i = li; i < NP; i += 32) {
    uh[l * NP + i] = p.state0[(0 * NP + i) * B + glc];
    ul[l * NP + i] = p.state0[(1 * NP + i) * B + glc];
    u1h[l * NP + i] = p.state0[(2 * NP + i) * B + glc];
    u1l[l * NP + i] = p.state0[(3 * NP + i) * B + glc];
  }
  if (li == 0) dtb0[l] = p.with_tri ? __fmul_rn(p.dt, p.b0[glc]) : 0.f;
  __syncthreads();

  for (int s = 0; s < p.nt; ++s) {
    const int step = p.step0 + s;
    const bool first = !p.bdf2 || step == 0;
    const float bdf = first ? 1.0f : 1.5f;

    // ---- A (warp per lane): dd predictor + history difference ----
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
    if constexpr (THETA) {
      for (int e = tid; e < kth * TL; e += nthreads) {
        const int k = e / TL, t = e - k * TL;
        const int lane = min(base + t, B - 1);
        const float* src =
            k < km8 ? p.THm + ((size_t)s * km8 + k) * B
            : k < km8 + kk8 ? p.THk + ((size_t)s * kk8 + k - km8) * B
                            : p.THf + ((size_t)s * kf8 + k - km8 - kk8) * B;
        th[e] = __ldg(src + lane);
      }
    }
    __syncthreads();

    // ---- B (block): MN and dtS per solve-matrix entry, lanes in registers ----
    for (int ij = tid; ij < NP2; ij += nthreads) {
      float mn[TL], sv[TL];
      if constexpr (THETA) {
#pragma unroll
        for (int t = 0; t < TL; ++t) mn[t] = sv[t] = 0.f;
        for (int k = 0; k < km8; ++k) {
          const float b = __ldg(&p.Bm[(size_t)ij * km8 + k]);
#pragma unroll
          for (int t = 0; t < TL; ++t) mn[t] = fmaf(b, th[k * TL + t], mn[t]);
        }
        for (int k = 0; k < kk8; ++k) {
          const float b = __ldg(&p.Bk[(size_t)ij * kk8 + k]);
#pragma unroll
          for (int t = 0; t < TL; ++t)
            sv[t] = fmaf(b, th[(km8 + k) * TL + t], sv[t]);
        }
      } else {
        const size_t row = ((size_t)s * NP2 + ij) * B;
#pragma unroll
        for (int t = 0; t < TL; ++t) {
          const int lane = min(base + t, B - 1);
          mn[t] = __ldg(&p.MN[row + lane]);
          sv[t] = __ldg(&p.KL[row + lane]);
        }
      }
      if (p.with_tri) {
        float nn[TL];
#pragma unroll
        for (int t = 0; t < TL; ++t) nn[t] = 0.f;
        for (int k = 0; k < NP; ++k) {
          const float q = __ldg(&p.T0[(size_t)ij * NP + k]);
#pragma unroll
          for (int t = 0; t < TL; ++t) nn[t] = fmaf(q, ph[t * NP + k], nn[t]);
        }
#pragma unroll
        for (int t = 0; t < TL; ++t)
          sv[t] = __fadd_rn(sv[t], __fmul_rn(nn[t], dtb0[t]));
      }
      const int i = ij / NP, j = ij - i * NP;
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        Mm[t * mat + i * lda + j] = mn[t];
        F[t * mat + i * lda + j] = sv[t];
      }
    }
    __syncthreads();

    // ---- C (block): r0 = MN·d + fN − dtS·pred and KN = bdf·MN + dtS ----
    for (int idx = tid; idx < TL * NP; idx += nthreads) {
      const int t = idx / NP, i = idx - t * NP;
      const int lane = min(base + t, B - 1);
      const float* mrow = Mm + t * mat + i * lda;
      float* frow = F + t * mat + i * lda;
      const float* d_t = dv + t * NP;
      const float* p_t = ph + t * NP;
      float mnd = 0.f, sp = 0.f;
      for (int j = 0; j < NP; ++j) {
        const float m = mrow[j], v = frow[j];
        mnd = fmaf(m, d_t[j], mnd);
        sp = fmaf(v, p_t[j], sp);
        frow[j] = fmaf(bdf, m, v);
      }
      float fn = 0.f;
      if constexpr (THETA) {
        for (int k = 0; k < kf8; ++k)
          fn = fmaf(__ldg(&p.Bf[i * kf8 + k]), th[(km8 + kk8 + k) * TL + t], fn);
      } else {
        fn = __ldg(&p.fN[((size_t)s * NP + i) * B + lane]);
      }
      xv[t * NP + i] = __fsub_rn(__fadd_rn(mnd, fn), sp);
    }
    __syncthreads();

    // ---- D (warp per lane): solve KN·δ = r0 ----
    float* A = F + l * mat;
    float* x = xv + l * NP;
    if (p.n_real <= GJ_MAX)
      gj_solve(A, NP, lda, x, p.n_real, li);
    else
      blocked_lu_solve(A, NP, lda, x, li);

    // ---- E (warp per lane): u = pred ⊕ δ, shift history, probes ----
    for (int i = li; i < NP; i += 32) {
      const int o = l * NP + i;
      float nh, nlo;
      dd_add_small(ph[o], pl[o], x[i], nh, nlo);
      u1h[o] = uh[o];
      u1l[o] = ul[o];
      uh[o] = nh;
      ul[o] = nlo;
    }
    __syncwarp();
    if (li < PROBE_P) {
      float acc = 0.f;
      for (int j = 0; j < NP; ++j)
        acc = fmaf(__ldg(&p.VE[li * NP + j]), uh[l * NP + j], acc);
      const size_t po = ((size_t)s * PROBE_P + li) * B;
      const float g = __ldg(&p.g[po + glc]);
      if (valid) p.probes[po + gl] = __fadd_rn(acc, g);
    }
    __syncthreads();
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

size_t smem_bytes(int TL, int NP, int kth) {
  const size_t mat = (size_t)NP * (NP + 1);
  return sizeof(float) * (2 * TL * mat + 8 * (size_t)TL * NP
                          + (size_t)kth * TL + TL);
}

template <bool THETA, int TL>
cudaError_t launch(const Params& p, int kth, cudaStream_t stream) {
  const size_t bytes = smem_bytes(TL, p.NP, kth);
  cudaError_t err = cudaFuncSetAttribute(
      resid_sweep_kernel<THETA, TL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int grid = (p.B + TL - 1) / TL;
  resid_sweep_kernel<THETA, TL><<<grid, TL * 32, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool THETA>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.NP > 32 * MAX_ROWS || p.NP % LU_BS != 0 || p.B < 1 || p.nt < 1 ||
      p.n_real < 1 || p.n_real > p.NP)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int kth = THETA ? p.km8 + p.kk8 + p.kf8 : 0;
  auto fits = [&](int TL) {
    return smem_bytes(TL, p.NP, kth) <= SMEM_LIMIT && (p.B + TL - 1) / TL >= sms;
  };
  if (fits(16)) return (int)launch<THETA, 16>(p, kth, stream);
  if (fits(8)) return (int)launch<THETA, 8>(p, kth, stream);
  if (fits(4)) return (int)launch<THETA, 4>(p, kth, stream);
  if (fits(2)) return (int)launch<THETA, 2>(p, kth, stream);
  return (int)launch<THETA, 1>(p, kth, stream);
}

}  // namespace

extern "C" {

// K2 on `stream`: one window's steps over materialized MN/KL/fN tables.
// Returns the cudaError_t of the launch (0 = ok).
int romtime_resid_sweep(const float* MN, const float* KL, const float* fN,
                        const float* g, const float* T0, const float* VE,
                        const float* b0, const float* state0, float* probes,
                        float* state, int nt, int NP, int B, int n_real,
                        int step0, int with_tri, int bdf2, float dt,
                        void* stream) {
  Params p{MN, KL, fN, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           g, T0, VE, b0, state0, probes, state,
           nt, NP, B, 0, 0, 0, n_real, step0, with_tri, bdf2, dt};
  return dispatch<false>(p, reinterpret_cast<cudaStream_t>(stream));
}

// K3 on `stream`: one window's steps with MN/KL/fN formed from θ streams.
int romtime_theta_resid_sweep(const float* THm, const float* THk,
                              const float* THf, const float* g,
                              const float* Bm, const float* Bk,
                              const float* Bf, const float* T0,
                              const float* VE, const float* b0,
                              const float* state0, float* probes,
                              float* state, int nt, int NP, int B, int km8,
                              int kk8, int kf8, int n_real, int step0,
                              int with_tri, int bdf2, float dt,
                              void* stream) {
  Params p{nullptr, nullptr, nullptr, THm, THk, THf, Bm, Bk, Bf,
           g, T0, VE, b0, state0, probes, state,
           nt, NP, B, km8, kk8, kf8, n_real, step0, with_tri, bdf2, dt};
  return dispatch<true>(p, reinterpret_cast<cudaStream_t>(stream));
}

const char* romtime_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
