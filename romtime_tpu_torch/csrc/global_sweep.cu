// Global-basis serving sweeps K4 and K5 for Hopper (sm_90a).
//
// Replaces, in romtime_tpu/ops/pallas_online.py,
// - _sweep_kernel (K4, behind online_sweep_pallas): per-step MN, KL and fN
//   read from materialized (nt, NP, NP, B) time tables;
// - _theta_sweep_kernel (K5, behind online_sweep_theta_pallas): MN = Bm·θm,
//   KL = Bk·θk and fN = Bf·θf formed per step in the kernel.
// One kernel template serves both; the compile-time flag THETA picks where
// the step's operators come from. Each launch runs the whole sweep of the
// plain-f32 BDF step (_bdf_step) from a zero state:
//
//   combo = 2·uN − ½·uN₋₁,  u* = 2·uN − uN₋₁   (BDF-2; BDF-1: uN, uN)
//   KN    = bdf·MN + KL + reshape(T0·u*)·dt·b0  (trilinear, optional)
//   bN    = Σ_j MN[:, j]·combo[j] + fN
//   uN    = Gauss-Jordan(KN, bN)  (pivot-free, the n_real rows in order:
//            pivot row scaled by 1/KN[k,k], every other row updated)
//   probes = VE·uN + g
//
// What bounds it on this card:
// - K4 is bound by bytes: it streams MN and KL, 2·NP²·4 bytes per
//   lane-step (2 KB at NP=16), against ~NP³ FMAs of the trilinear term
//   and ~n·NP² of the elimination: ~4 FLOP per byte, far below the ~20 at
//   which the FP32 rate would take over.
// - K5 is bound by operations: per lane-step NP²·(km8 + kk8) FMAs for the
//   operators (2.3e4 at NP=24, km8 + kk8 = 40), NP³ for the trilinear term
//   and n·NP² for the elimination, against (km8 + kk8 + kf8 + 16)·4 bytes
//   of θ, probe and output streams.
//
// Design (simple and right first):
// - one thread block per tile of TL lanes (μ), NP·TL threads, thread
//   (i, t) = row i of lane t, lanes fastest: a warp reads 32/TL rows of TL
//   neighbouring lanes, so every read of the lane-minor tables is a run of
//   TL·4 contiguous bytes (whole 32-byte sectors for TL ≥ 8), the access
//   the byte-bound K4 needs;
// - the step's tables (K4: MN, KL, fN, g; K5: θm, θk, θf, g) are copied
//   into shared memory one step ahead with cp.async (double-buffered), so
//   their loads are in flight while the block solves the step before;
// - per-lane matrices live lane-minor in shared memory, each matrix row
//   padded by TL floats, so the 32/TL rows of a warp fall on distinct
//   banks;
// - K5's constants Bm, Bk, Bf and T0 stay in device memory, read through
//   the read-only cache: at NP=24, kk8=32 they take ~150 KB, which beside
//   the per-lane matrices and the staged tables would leave room for one
//   block per SM at best, and at NP=64 they outgrow shared memory. Every
//   constant read serves the TL lanes of a row at once (a broadcast);
// - the elimination is the reference's Gauss-Jordan, row-parallel: per
//   pivot every thread updates its own row from the unscaled pivot row,
//   and the pivot row's scaling waits for its owner's next update; one
//   block barrier per pivot. The padded block of KN is the identity, so
//   the padded rows of uN stay exact 0;
// - plain FP32 FMAs, no tensor cores (no TF32 anywhere);
// - TL is the largest of 16/8/4/2/1 that fits 227 KB of shared memory and
//   1024 threads and still gives every SM a block; a shape that fits no
//   tile is refused (cudaErrorInvalidValue), never run.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int PROBE_P = 8;
constexpr size_t SMEM_LIMIT = 232448;
constexpr int MAX_THREADS = 1024;

struct Params {
  const float* MN;    // K4: (nt, NP, NP, B)
  const float* KL;    // K4: (nt, NP, NP, B)
  const float* fN;    // K4: (nt, NP, B)
  const float* THm;   // K5: (nt, km8, B)
  const float* THk;   // K5: (nt, kk8, B)
  const float* THf;   // K5: (nt, kf8, B)
  const float* Bm;    // K5: (NP², km8)
  const float* Bk;    // K5: (NP², kk8)
  const float* Bf;    // K5: (NP, kf8)
  const float* g;     // (nt, PROBE_P, B)
  const float* T0;    // (NP², NP)
  const float* VE;    // (PROBE_P, NP)
  const float* b0;    // (1, B)
  float* probes;      // (nt, PROBE_P, B)
  float* uN;          // (NP, B)
  int nt, NP, B, km8, kk8, kf8, n_real, with_tri, bdf2;
  float dt;
};

// Floats of one step's staged tables for a tile of TL lanes.
__host__ __device__ size_t stage_floats(bool theta, int NP, int km8, int kk8,
                                        int kf8, int TL) {
  const size_t rows = theta ? (size_t)(km8 + kk8 + kf8 + PROBE_P)
                            : (size_t)(2 * NP * (NP + 1) + NP + PROBE_P);
  return rows * TL;
}

// Asynchronous copy of `nrows` rows (B floats apart in device memory,
// lanes base.. of each) into the stage, lane-minor. The block has NP·TL
// threads, so thread (i, t) copies lane t of rows i, i + NP, i + 2·NP, …:
// lanes fastest, as the rows lie in device memory. With `padded` (a
// matrix), row r lands at stage row r + r / NP (one padding row per
// matrix row), which is row + its iteration count here.
template <int TL>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int nrows, bool padded, int NP,
                                           int B, int base, int i, int t) {
  const float* from = src + min(base + t, B - 1);
  for (int r = i, it = 0; r < nrows; r += NP, ++it)
    __pipeline_memcpy_async(dst + (padded ? r + it : r) * TL + t,
                            from + (size_t)r * B, sizeof(float));
}

template <bool THETA, int TL>
__device__ __forceinline__ void stage_step(const Params& p, float* st, int s,
                                           int base, int i, int t) {
  const int NP = p.NP, B = p.B;
  if constexpr (THETA) {
    const int km8 = p.km8, kk8 = p.kk8, kf8 = p.kf8;
    stage_rows<TL>(st, p.THm + (size_t)s * km8 * B, km8, false, NP, B, base,
                   i, t);
    stage_rows<TL>(st + km8 * TL, p.THk + (size_t)s * kk8 * B, kk8, false,
                   NP, B, base, i, t);
    stage_rows<TL>(st + (km8 + kk8) * TL, p.THf + (size_t)s * kf8 * B, kf8,
                   false, NP, B, base, i, t);
    stage_rows<TL>(st + (km8 + kk8 + kf8) * TL,
                   p.g + (size_t)s * PROBE_P * B, PROBE_P, false, NP, B,
                   base, i, t);
  } else {
    const int NP2 = NP * NP, mrows = NP * (NP + 1);
    stage_rows<TL>(st, p.MN + (size_t)s * NP2 * B, NP2, true, NP, B, base,
                   i, t);
    stage_rows<TL>(st + mrows * TL, p.KL + (size_t)s * NP2 * B, NP2, true,
                   NP, B, base, i, t);
    stage_rows<TL>(st + 2 * mrows * TL, p.fN + (size_t)s * NP * B, NP, false,
                   NP, B, base, i, t);
    stage_rows<TL>(st + (2 * mrows + NP) * TL, p.g + (size_t)s * PROBE_P * B,
                   PROBE_P, false, NP, B, base, i, t);
  }
  __pipeline_commit();
}

template <bool THETA, int TL>
__global__ void __launch_bounds__(MAX_THREADS)
global_sweep_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NP = p.NP, B = p.B, n = p.n_real;
  const int km8 = p.km8, kk8 = p.kk8, kf8 = p.kf8;
  const int ld = NP + 1;                     // padded row length, in rows
  const size_t sf = stage_floats(THETA, NP, km8, kk8, kf8, TL);

  float* stage = smem;                       // 2 × sf: double buffer
  float* A = stage + 2 * sf;                 // NP × ld rows × TL: KN
  float* x = A + (size_t)NP * ld * TL;       // NP × TL: bN, then uN
  float* us = x + NP * TL;                   // NP × TL: u*
  float* cb = us + NP * TL;                  // NP × TL: combo

  const int tid = threadIdx.x;               // NP·TL threads
  const int i = tid / TL, t = tid - i * TL;  // row i of lane t
  const int base = static_cast<int>(blockIdx.x) * TL;
  const int gl = base + t;
  const bool valid = gl < B;
  const int glc = valid ? gl : B - 1;
  const float dtb = p.with_tri ? __fmul_rn(p.dt, p.b0[glc]) : 0.f;

  float u = 0.f, u1 = 0.f;                   // this thread's entry of uN, uN₋₁
  us[i * TL + t] = 0.f;
  cb[i * TL + t] = 0.f;
  stage_step<THETA, TL>(p, stage, 0, base, i, t);

  for (int s = 0; s < p.nt; ++s) {
    const float* st = stage + (s & 1) * sf;
    __pipeline_wait_prior(0);
    __syncthreads();
    // The other buffer was read in step s − 1, which every thread has left.
    if (s + 1 < p.nt)
      stage_step<THETA, TL>(p, stage + ((s + 1) & 1) * sf, s + 1, base, i,
                            t);
    const float bdf = (p.bdf2 && s > 0) ? 1.5f : 1.0f;

    // ---- operators, KN and bN, row i of lane t ----
    const float* th_m = st;
    const float* th_k = st + km8 * TL;
    const float* th_f = st + (km8 + kk8) * TL;
    const float* Mrow = st + (size_t)i * ld * TL;
    const float* Krow = Mrow + (size_t)NP * ld * TL;
    float acc = 0.f;
    for (int j = 0; j < NP; ++j) {
      float m, kl;
      if constexpr (THETA) {
        const float* bm = p.Bm + (size_t)(i * NP + j) * km8;
        const float* bk = p.Bk + (size_t)(i * NP + j) * kk8;
        m = 0.f;
        kl = 0.f;
#pragma unroll 8
        for (int k = 0; k < km8; ++k)
          m = fmaf(__ldg(bm + k), th_m[k * TL + t], m);
#pragma unroll 8
        for (int k = 0; k < kk8; ++k)
          kl = fmaf(__ldg(bk + k), th_k[k * TL + t], kl);
      } else {
        m = Mrow[j * TL + t];
        kl = Krow[j * TL + t];
      }
      float kn = fmaf(bdf, m, kl);
      if (p.with_tri && i < n && j < n) {
        // T0 is zero outside the n real rows, columns and entries.
        const float* q = p.T0 + (size_t)(i * NP + j) * NP;
        float nn = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) nn = fmaf(__ldg(q + k), us[k * TL + t], nn);
        kn = fmaf(nn, dtb, kn);
      }
      A[((size_t)i * ld + j) * TL + t] = kn;
      acc = fmaf(m, cb[j * TL + t], acc);
    }
    float fn;
    if constexpr (THETA) {
      fn = 0.f;
      for (int k = 0; k < kf8; ++k)
        fn = fmaf(__ldg(p.Bf + i * kf8 + k), th_f[k * TL + t], fn);
    } else {
      fn = st[(size_t)(2 * NP * ld + i) * TL + t];
    }
    float xi = acc + fn;                     // row i of bN, then of uN
    x[i * TL + t] = xi;

    // ---- pivot-free Gauss-Jordan over the n real rows ----
    // Pivot k: every other row takes KN[i,k]·row_k / KN[k,k] off, read
    // from the unscaled pivot row; the pivot row's own scaling by
    // 1/KN[k,k] waits in `sc` for its owner's next update, since no other
    // thread reads that row again. So a pivot needs one block barrier.
    float* Ai = A + (size_t)i * ld * TL;
    float sc = 1.0f;                         // pending scale of row i
    for (int k = 0; k < n; ++k) {
      __syncthreads();
      if (i == k) {
        sc = 1.0f / Ai[k * TL + t];
        continue;
      }
      const float* Ak = A + (size_t)k * ld * TL;
      const float inv = 1.0f / Ak[k * TL + t];
      const float c = Ai[k * TL + t] * sc;
#pragma unroll 4
      for (int j = k + 1; j < NP; ++j)
        Ai[j * TL + t] = fmaf(-c, Ak[j * TL + t] * inv, Ai[j * TL + t] * sc);
      xi = fmaf(-c, x[k * TL + t] * inv, xi * sc);
      x[i * TL + t] = xi;
      sc = 1.0f;
    }
    __syncthreads();                         // row n − 1 was read above
    x[i * TL + t] = xi * sc;
    __syncthreads();

    // ---- probes, state shift, next predictor ----
    if (i < PROBE_P) {
      float pr = 0.f;
      for (int j = 0; j < NP; ++j)
        pr = fmaf(__ldg(p.VE + i * NP + j), x[j * TL + t], pr);
      const float* gs = THETA ? st + (km8 + kk8 + kf8) * TL
                              : st + (size_t)(2 * NP * ld + NP) * TL;
      if (valid)
        p.probes[((size_t)s * PROBE_P + i) * B + gl] = pr + gs[i * TL + t];
    }
    u1 = u;
    u = x[i * TL + t];
    if (p.bdf2) {
      us[i * TL + t] = 2.0f * u - u1;
      cb[i * TL + t] = 2.0f * u - 0.5f * u1;
    } else {
      us[i * TL + t] = u;
      cb[i * TL + t] = u;
    }
  }
  if (valid) p.uN[(size_t)i * B + gl] = u;
}

size_t smem_bytes(bool theta, int NP, int km8, int kk8, int kf8, int TL) {
  return sizeof(float) * (2 * stage_floats(theta, NP, km8, kk8, kf8, TL) +
                          (size_t)NP * (NP + 1) * TL + 3 * (size_t)NP * TL);
}

template <bool THETA, int TL>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(THETA, p.NP, p.km8, p.kk8, p.kf8, TL);
  cudaError_t err = cudaFuncSetAttribute(
      global_sweep_kernel<THETA, TL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int grid = (p.B + TL - 1) / TL;
  global_sweep_kernel<THETA, TL><<<grid, p.NP * TL, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool THETA>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.NP % 8 != 0 || p.NP < PROBE_P || p.B < 1 || p.nt < 1 ||
      p.n_real < 1 || p.n_real > p.NP)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  auto holds = [&](int TL) {
    return p.NP * TL <= MAX_THREADS &&
           smem_bytes(THETA, p.NP, p.km8, p.kk8, p.kf8, TL) <= SMEM_LIMIT;
  };
  auto fills = [&](int TL) { return holds(TL) && (p.B + TL - 1) / TL >= sms; };
  if (fills(16)) return (int)launch<THETA, 16>(p, stream);
  if (fills(8)) return (int)launch<THETA, 8>(p, stream);
  if (fills(4)) return (int)launch<THETA, 4>(p, stream);
  if (fills(2)) return (int)launch<THETA, 2>(p, stream);
  if (holds(1)) return (int)launch<THETA, 1>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K4 on `stream`: the whole sweep over materialized MN/KL/fN tables.
// Returns the cudaError_t of the launch (0 = ok).
int romtime_global_sweep(const float* MN, const float* KL, const float* fN,
                         const float* g, const float* T0, const float* VE,
                         const float* b0, float* probes, float* uN, int nt,
                         int NP, int B, int n_real, int with_tri, int bdf2,
                         float dt, void* stream) {
  Params p{MN, KL, fN, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           g, T0, VE, b0, probes, uN,
           nt, NP, B, 0, 0, 0, n_real, with_tri, bdf2, dt};
  return dispatch<false>(p, reinterpret_cast<cudaStream_t>(stream));
}

// K5 on `stream`: the whole sweep with MN/KL/fN formed from θ streams.
int romtime_theta_global_sweep(const float* THm, const float* THk,
                               const float* THf, const float* g,
                               const float* Bm, const float* Bk,
                               const float* Bf, const float* T0,
                               const float* VE, const float* b0,
                               float* probes, float* uN, int nt, int NP,
                               int B, int km8, int kk8, int kf8, int n_real,
                               int with_tri, int bdf2, float dt,
                               void* stream) {
  Params p{nullptr, nullptr, nullptr, THm, THk, THf, Bm, Bk, Bf,
           g, T0, VE, b0, probes, uN,
           nt, NP, B, km8, kk8, kf8, n_real, with_tri, bdf2, dt};
  return dispatch<true>(p, reinterpret_cast<cudaStream_t>(stream));
}

const char* romtime_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
