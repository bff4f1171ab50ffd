// The serving body for Hopper (sm_90a): one kernel template that runs
// K1's serving design (csrc/windowed_serving.cu), K3 on the same body
// (csrc/windowed_serving.cu), K5 (csrc/global_serving.cu), and, with
// their operators read from materialized tables, K2
// (csrc/resid_tables_serving.cu) and K4 (csrc/global_tables_serving.cu).
// Each entry fills Params and launches serving_kernel<NP, CLOCKED, PLAIN,
// MAT>.
//
// What it runs: a μ batch's windowed BDF trajectory, W windows of `width`
// steps, each step's solve matrix formed in the kernel from θ streams and
// the folded combine Bmk = [Bm | Bk | T0] of its window. Two step forms:
// - the dd residual step (PLAIN = false; K1's _windowed_fused_kernel and
//   K3's _theta_sweep_kernel_v2 in romtime_tpu/ops/pallas_online.py): the
//   double-f32 carry (u, the previous u) with the dd BDF-2 predictor,
//   KN·δ = r0 and u = pred ⊕ δ (dd add); the carry comes in (state0) and
//   goes out (state). K1 transfers the carry through T_w at each window
//   start (`boundary`); K3 runs one window, no transfer (its engine
//   applies T_w outside), from global step `step0`;
// - the plain-f32 step (PLAIN = true; K5's _theta_sweep_kernel, the
//   reference's _bdf_step): u* = 2u − u₋₁ and combo = 2u − ½u₋₁ (BDF-1:
//   u, u), KN = fmaf(bdf, MN, KL) and then fmaf(N, dt·b0, KN) with
//   N = T0·u*, bN = MN·combo + fN, uN = KN⁻¹bN, from a zero carry with no
//   low words; uN goes out. Each of these sums and products is rounded as
//   in K4 and K5's first designs (csrc/global_sweep.cu), so that the
//   served K5 stays within the reference's 3e-6 of K4: over 1500 steps a
//   different rounding order alone moves the time-mean probes by ~2e-5
//   of their scale.
// Both: probes = VE·u + g per step.
//
// The solves are pivot-free (behind certify_pivot_free on the host). The
// dd step runs the panel LU over all NP pivots below; the reference's K3
// runs Gauss-Jordan over n_real pivots (≤ 20) or a blocked LU: the same
// system, since the padded block of KN is the identity and decoupled
// from the real rows. The PLAIN step runs K5's own Gauss-Jordan over the
// n_real pivots (gj_solve). Either way the padded entries of u and the
// padded probe rows stay exact zeros.
//
// What bounds it on this card. Per lane-step the work is the solve matrix
// KN = Bmk·rhs over the live θ rows (NP²·(km + kk + NP) FMAs: 57k at
// 50x32), three NP² matvecs, fN and the solve (~12k at 50x32). The
// first design also formed the trilinear term a second time as a quadratic
// form (NP³) and r0 by factored matvecs, and issued ~1.6 load or store
// instructions per FMA from one warp per lane: it was bound by the
// memory-instruction pipe, at ~20× its operation bound.
//
// What this design does about it:
// - the trilinear term is formed once. The Bmk k-loop runs in three
//   segments, each accumulated into a register row: the mass rows
//   (unscaled) give row i of MN, the stiffness rows row i of KL, the T0
//   rows against dt·b0·pred row i of N. Then KN = bdf·MN + KL + N and
//   r0 = MN·d + fN − KL·pred − N·pred, each term from its segment's row
//   before it is folded, combined in the reference's order (the PLAIN
//   step forms bN = MN·combo + fN, the mass segment's dot only, and
//   streams N's rows against u* itself). TQ, BmF and
//   BkF are never read. Only live θ rows (km mass, kk stiffness rows; a
//   padded row is an exact zero) are streamed;
// - register-resident rows: one thread owns row i of one lane's matrix
//   (NP is a template parameter; rows are fully unrolled register
//   arrays). Per k it reads Bmk[k, i, :] as float4s from shared memory
//   and rhs[k] as a broadcast. Four lanes form a group of NP/8 warps, and
//   a warp holds 8 rows of each of the 4 lanes: its 32 threads read 8
//   distinct rows, each as one broadcast to 4 lanes, so a float4 read of
//   the warp is one 128-byte shared-memory wavefront, where a warp of 32
//   distinct rows would need four. The shared-memory stream then matches
//   the FMA issue rate instead of holding the build to a quarter of it.
//   The LU eliminates [KN | r0] in place in the rows (forward
//   substitution folded in), in panels of 8 pivots: the 8 rows of a panel
//   are one warp, which factors them among itself and writes them to
//   shared memory once (as float4s); the rows below apply them after one
//   group barrier, so a solve takes NP/8 group barriers, not NP. The
//   substitutions use the row each thread holds, a panel's entries
//   resolved by shuffles inside its warp; the LU step substitutes with the
//   row each thread holds. A sub1 leader writes its factor rows once to a
//   slot in shared memory (each thread writes and reads only its own);
//   its followers substitute with them there, 8 entries at a time, each
//   keeping its own KN row in registers for the refinement residual.
//   Under Richardson each window's K̄ comes from the same segmented build
//   and is inverted by Gauss-Jordan on the rows each thread owns; its K̄⁻¹
//   row is written once to the same slot, and each step's solve_iters
//   matvec pairs read it as float4s against the KN row held in registers.
//   KN never goes through shared memory. Only the build (KN and a
//   segment) and the inversion (K̄ and its inverse) hold two register
//   rows;
// - constants staged by asynchronous copies: each step's Bmk k-slices go
//   through a 3-stage shared-memory ring, a chunk of ks slices filled two
//   chunks ahead while the warps compute on the current one, by bulk
//   copies (cp.async.bulk, the TMA without a tensor map) that one thread
//   issues, at most three a chunk (one per θ segment it touches),
//   completing on the slot's mbarrier. The wrapper hands Bmk with each
//   slice's rows padded to NP + 4 floats (Bmk_pad, (W, kfold, NP, NP+4)),
//   so a chunk lands padded and 8 consecutive rows read as float4s hit 8
//   distinct bank quads (no bank conflicts). Each window's Tp, VE (rows
//   padded the same way) and Bf are staged at the window start by three
//   bulk copies on a fourth mbarrier. Bmk per window (229 KB at
//   50x32, 664 KB at 150x48) is larger than a block's 227 KB, so it
//   streams by k-slice: ks, the largest ≤ 16 that fits beside the lane
//   tile, is chosen on the host;
// - plain FP32 on the CUDA cores, no tensor cores and no TF32. The dd
//   carry, the boundary transfer and dd_add_small use __fadd_rn/__fmul_rn
//   with TwoProduct's error term from fmaf (csrc/dd.cuh). The solve is
//   pivot-free (behind certify_pivot_free on the host); the paired-LU
//   schedule is step_roles with the reference's period.
//
// The carry (u, the previous u, δ) lives in the owner's entries of
// per-lane shared vectors, so the registers hold the rows and little else.
//
// What still bounds it (its phase clocks, chip_smoke.py): the build, now
// at the FMA rate of one shared-memory wavefront per float4; the solve's
// chains (2·NP/8 group barriers, four substitutions for a follower); the
// ring's per-chunk barrier and copies. It stays ~5-9× its operation bound.
//
// The materialized operand source (MAT, a template flag; K2 on the dd
// step, K4 on the PLAIN step, one window of nt steps). MN, KL and fN
// come from per-lane tables in device memory, laid out lane-major with
// the body's row padding: MN, KL (nt, B, NP, NP + 4) and fN (nt, B, NP),
// so a block's step tile of its TL lanes is one contiguous run of each
// table. The mass and stiffness segments of the build are replaced by a
// row load: each thread reads row i of its lane's MN (with its entry of
// fN) and of its KL as float4s from a second shared-memory ring, then
// combines them as the segments' ends do (r0 = MN·d + fN, KN = bdf·MN,
// then KL: dd r0 −= KL·pred, KN += KL; PLAIN KN = fmaf(bdf, MN, KL)).
// Everything after that point is the θ source's: the T0 segment streams
// through the Bmk ring (the only slices left), then the solve, the dd add
// and the probes. The table ring holds `mu` units (2 or 3), a unit the
// block's MN tile and fN, or its KL tile, of one step; thread 0 fills
// each by one or two bulk copies on the unit's mbarrier, mu − 1 units
// ahead, so at mu = 3 the next step's MN is in flight for a whole step.
// A table is read once and never reused across lanes or steps, so the
// stream is whole sectors from device memory. The lanes a block (TL = 4,
// 8 or 16, at most 16 lanes at NP ≤ 32, 8 at NP 40 and 4 above) are a
// launch parameter chosen on the host from the batch, so that a small
// batch still gives every SM a block; the kernel's register cap is that
// of its largest tile.
//
// CLOCKED (a template flag; NP 32 and 48 of the dd step, NP 24 of the
// PLAIN step; with MAT, NP 32 and 48 of K2 and NP 16 of K4) adds clock()
// reads by the block's last thread at each phase boundary; each block's
// sums go to an int64 output (PHASES + 1 a block: the phases, then the
// total), so the phase split comes from the same compiled body as the
// served kernel. Under MAT the table ring's waits count as slice wait,
// the row loads as build and the MN·d, KL·pred dots as r0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dd.cuh"

namespace {

constexpr int PROBE_P = 8;
constexpr int STAGES = 3;           // Bmk ring depth
constexpr int KS_MAX = 16;          // k-slices per chunk, at most
constexpr int GL = 4;               // lanes of a group
// Dynamic shared memory of a block: the 227 KB less the static part (the
// ring's mbarriers and the phase clocks).
constexpr size_t SMEM_LIMIT = 232448 - 256;

// A compiler fence: shared-memory loads are not hoisted across it. The
// products of a register row with shared rows (the dots, a pivot row's
// update, the Gauss-Jordan step) run while one or two rows are live;
// issued all ahead, their float4 loads would hold up to 2·NP more
// registers and push NP 32 and 48 past their cap. Every second float4 is
// fenced.
__device__ __forceinline__ void load_fence() {
  asm volatile("" ::: "memory");
}

// Phase clocks (CLOCKED), in the order of the output row.
enum Phase { PH_BOUNDARY = 0, PH_WAIT, PH_BUILD, PH_R0, PH_SOLVE, PH_KBAR,
             PH_UPDATE, PHASES };

template <int NP, bool PLAIN = false>
struct Tile {
  static constexpr int GT = GL * NP;               // threads of a group
  // Lanes of a block: one block an SM holds its registers (65,536 /
  // THREADS a thread at most). NP 48 needs ~185; at 8 lanes (384
  // threads, 168 registers) ptxas spilled 4 bytes, so it takes 4 lanes
  // (255), as NP 56 and 64 do. The PLAIN step serves the global cells
  // (B=2048 at NP 16 and 24): 16 lanes at NP ≤ 16 give 128 blocks for
  // the 132 SMs, where 32 would leave half the card idle.
  static constexpr int TL =
      NP <= 16 ? (PLAIN ? 16 : 32)
               : (NP <= 32 ? 16 : (NP <= 40 ? 8 : 4));
  static constexpr int THREADS = TL * NP;
  static constexpr int LD = NP + 4;                // padded row (floats)
  static constexpr int NQ = NP / 4;                // float4s a row
  static constexpr int PR = NP + 4;                // panel row stride
};

// The materialized source's largest lane tile (its register cap): 16
// lanes at NP ≤ 32, 8 at NP 40, 4 above (as the θ source at NP ≥ 40).
template <int NP>
struct MatTile {
  static constexpr int TLMAX = NP <= 32 ? 16 : (NP <= 40 ? 8 : 4);
};
constexpr int MU_MAX = 3;           // table ring depth (units), at most

struct Params {
  const float* TH;     // (nt, K8, B)
  const float* Bmk;    // (W, kfold, NP, NP + 4): rows padded
  const float* Bf;     // (W, kf8, NP)
  const float* VE;     // (W, PROBE_P, NP + 4): rows padded
  const float* Tp;     // (W, NP, NP + 4): rows padded
  const float* b0;     // (1, B)
  const float* state0; // (4, NP, B); PLAIN: unread (zero carry)
  const float* THbar;  // (W, km8 + kk8, B), read only with solve_iters > 0
  float* probes;       // (nt, PROBE_P, B)
  float* state;        // (4, NP, B); PLAIN: uN (NP, B)
  long long* clk;      // (grid, PHASES + 1), CLOCKED only
  int W, width, period, B, km8, kk8, kf8, km, kk, with_tri, bdf2, group,
      solve_iters, ks;
  // The launch's first global step (BDF-1 at global step 0 only; θ and
  // probe rows are indexed by the local step), whether each window
  // starts with the dd transfer through T_w (K1) or not (K3, K5), and the
  // pivots of the PLAIN step's Gauss-Jordan (the real rows).
  int step0, boundary, n_real;
  float dt;
  // MAT: the lane-major tables MN, KL (nt, B, NP, NP + 4) and fN
  // (nt, B, NP) (TH is then g (nt, PROBE_P, B)), the lanes a block, the
  // table ring's units and their size and offset (floats).
  const float* MN;
  const float* KL;
  const float* fN;
  int tl, mu, mat_slot, o_mat;
  // Derived on the host (set_shape), so that the kernel reads them from
  // the constant bank instead of holding them in registers.
  int kmk8, K8, kfold, off_g, nth, nlive, nchunk, per_w, slot;
  int o_fac, o_tps, o_ves, o_bfs, o_lanes, lanef, o_thf, o_gv;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Floats of one lane's scratch: vectors P (pred), PL (its low word), D,
// X, R, the carry CH/CL (u), C1H/C1L (the previous u), DP (δ) (10·NP),
// the panel of 8 pivot rows (8·(NP + 4)), rhs, θf and g.
__host__ __device__ inline int lane_floats(int NP, int kmk8, int kf8) {
  return 10 * NP + 8 * (NP + 4) + round4(kmk8 + NP) + round4(kf8) + PROBE_P;
}

__host__ __device__ inline size_t smem_floats(int NP, int TL, int ks,
                                              int kmk8, int kf8) {
  const int LD = NP + 4;
  return (size_t)STAGES * ks * NP * LD     // Bmk ring
         + (size_t)TL * NP * LD            // factor / K̄⁻¹ rows
         + (size_t)(NP + PROBE_P) * LD     // Tp, VE
         + (size_t)round4(kf8) * NP        // Bf
         + (size_t)TL * lane_floats(NP, kmk8, kf8);
}

// The ring's mbarriers: one arrival (the expect-tx of thread 0) and the
// bytes of the chunk's bulk copies complete a fill.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// One bulk copy (TMA, no tensor map) of `bytes` from global memory into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Barrier of one group of GL lanes (GT threads): the warp, or the named
// barrier 1 + group (id 0 is __syncthreads).
template <int GT>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (GT == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(GT) : "memory");
  }
}

// Solve role of step s of a period (ops/windowed_fused.py step_roles):
// 0 = full LU, 1 = group leader (factorize, keep), 2 = follower.
__device__ __forceinline__ int step_role(int s, int period, int group) {
  if (group < 2) return 0;
  const int lead = period < 2 ? period : 2;
  const int q = s - lead;
  if (q < 0 || q >= ((period - lead) / group) * group) return 0;
  return (q % group) == 0 ? 1 : 2;
}

// a · v for a register row and a shared vector (float4 broadcasts, at
// most two in flight).
template <int NP>
__device__ __forceinline__ float dot_row(const float (&a)[NP],
                                         const float* v) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    if (q % 2 == 0) load_fence();
    const float4 b = v4[q];
    acc = fmaf(a[4 * q], b.x, acc);
    acc = fmaf(a[4 * q + 1], b.y, acc);
    acc = fmaf(a[4 * q + 2], b.z, acc);
    acc = fmaf(a[4 * q + 3], b.w, acc);
  }
  return acc;
}

// u · v for two shared vectors (float4 loads, at most two pairs in
// flight): the probes and the δ transfer.
template <int NP>
__device__ __forceinline__ float dot_shared(const float* u, const float* v) {
  const float4* u4 = reinterpret_cast<const float4*>(u);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    if (q % 2 == 0) load_fence();
    const float4 x = u4[q], y = v4[q];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

template <int NP>
__device__ __forceinline__ void store_row(float* dst, const float (&a)[NP]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < NP / 4; ++q)
    d4[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
}

// Row i of the dd matvec T·(xh + xl) (ops/compensated.py dd_matvec):
// 8-column chunks of exact products reduced by a pairwise dd tree; T is
// row i of the staged transfer, xh/xl shared vectors.
template <int NP>
__device__ void dd_matvec_row(const float* T, const float* xh,
                              const float* xl, float& out_h, float& out_l) {
  float acc_h = 0.f, acc_l = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < NP; c0 += 8) {
    float ph[8], pl[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float t = T[c0 + c];
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

// The solves work in panels of 8 pivots: the rows 8p..8p+7 of a lane are
// the rows of warp p of its group (for the group's 4 lanes), so a panel
// is resolved inside one warp (__syncwarp, shuffles) and the other warps
// meet it at one group barrier, NP/8 a solve instead of NP.

// Row `row` (in A, y) loses lk·(pivot row k) for lk = A[k]/U[k][k]; u is
// the pivot row k of the panel buffer: U[k][k+1..], then y_k and
// 1/U[k][k].
template <int NP, int K>
__device__ __forceinline__ void apply_pivot(float (&A)[NP], float& y,
                                            const float* u) {
  const float2 s = *reinterpret_cast<const float2*>(u + NP);
  const float lk = A[K] * s.y;
  A[K] = lk;
#pragma unroll
  for (int q = (K + 1) / 4; q < NP / 4; ++q) {
    if (q % 2 == 0) load_fence();
    const float4 v = reinterpret_cast<const float4*>(u)[q];
    if (4 * q > K) A[4 * q] = fmaf(-lk, v.x, A[4 * q]);
    if (4 * q + 1 > K) A[4 * q + 1] = fmaf(-lk, v.y, A[4 * q + 1]);
    if (4 * q + 2 > K) A[4 * q + 2] = fmaf(-lk, v.z, A[4 * q + 2]);
    if (4 * q + 3 > K) A[4 * q + 3] = fmaf(-lk, v.w, A[4 * q + 3]);
  }
  y = fmaf(-lk, s.x, y);
}

template <int NP, int P, int KK = 0>
__device__ __forceinline__ void panel_factor(float (&A)[NP], float& y,
                                             float& inv, int row,
                                             float* pan) {
  if constexpr (KK < 8) {
    constexpr int K = 8 * P + KK;
    float* u = pan + KK * Tile<NP>::PR;
    if (row == K) {
      inv = 1.0f / A[K];
#pragma unroll
      for (int q = (K + 1) / 4; q < NP / 4; ++q)
        reinterpret_cast<float4*>(u)[q] =
            make_float4(A[4 * q], A[4 * q + 1], A[4 * q + 2], A[4 * q + 3]);
      u[NP] = y;
      u[NP + 1] = inv;
    }
    __syncwarp();
    if (row > K) apply_pivot<NP, K>(A, y, u);
    load_fence();
    panel_factor<NP, P, KK + 1>(A, y, inv, row, pan);
  }
}

template <int NP, int P, int KK = 0>
__device__ __forceinline__ void panel_apply(float (&A)[NP], float& y,
                                            const float* pan) {
  if constexpr (KK < 8) {
    apply_pivot<NP, 8 * P + KK>(A, y, pan + KK * Tile<NP>::PR);
    load_fence();
    panel_apply<NP, P, KK + 1>(A, y, pan);
  }
}

// Pivot-free elimination of [A | y] in the rows (thread `row` holds row
// `row` of A and entry y), panel by panel: warp p factors its 8 rows,
// writes them (with y and 1/pivot) to the panel buffer, and every row
// below applies the 8 pivots in order. Afterwards A holds L (unit, below
// the diagonal) and U, y = L⁻¹y, and inv = 1/U[row][row].
template <int NP, int GT, int P = 0>
__device__ __forceinline__ void eliminate(float (&A)[NP], float& y,
                                          float& inv, int row, int grp,
                                          float* pan) {
  if constexpr (P < NP / 8) {
    if (row / 8 == P) panel_factor<NP, P>(A, y, inv, row, pan);
    group_sync<GT>(grp);
    if (row >= 8 * P + 8) panel_apply<NP, P>(A, y, pan);
    if constexpr (P + 1 < NP / 8) {
      group_sync<GT>(grp);   // the panel is read: the next may overwrite it
      eliminate<NP, GT, P + 1>(A, y, inv, row, grp, pan);
    }
  }
}

// The substitutions read this row's factors from its row in shared
// memory (F: L left of the diagonal, U from it on, 1/U[row][row] at
// F[NP]), 8 at a time as two float4s, so no register row is held for
// them.
template <int NP, int P>
__device__ __forceinline__ void panel_row(const float* F, float (&f)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(F + 8 * P)[0];
  const float4 hi = reinterpret_cast<const float4*>(F + 8 * P)[1];
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

// y ← L⁻¹y with the unit lower factor: warp p resolves its 8 entries by
// shuffles (row 8p+kk of lane a is warp lane 4·kk + a) and publishes them
// in xs; the rows below subtract them. The panels are a template
// recursion, so every index is a compile-time constant.
template <int NP, int GT, int P = 0>
__device__ __forceinline__ void forward(const float* F, float& y, int row,
                                        int a, int grp, float* xs) {
  if constexpr (P < NP / 8) {
    if (row / 8 == P) {
      float f[8];
      panel_row<NP, P>(F, f);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float yk = __shfl_sync(0xffffffffu, y, 4 * kk + a);
        if (row > 8 * P + kk) y = fmaf(-f[kk], yk, y);
      }
      xs[row] = y;
    }
    group_sync<GT>(grp);
    if (row >= 8 * P + 8) {
      float f[8];
      panel_row<NP, P>(F, f);
      const float4 lo = reinterpret_cast<const float4*>(xs + 8 * P)[0];
      const float4 hi = reinterpret_cast<const float4*>(xs + 8 * P)[1];
      y = fmaf(-f[0], lo.x, y);
      y = fmaf(-f[1], lo.y, y);
      y = fmaf(-f[2], lo.z, y);
      y = fmaf(-f[3], lo.w, y);
      y = fmaf(-f[4], hi.x, y);
      y = fmaf(-f[5], hi.y, y);
      y = fmaf(-f[6], hi.z, y);
      y = fmaf(-f[7], hi.w, y);
    }
    forward<NP, GT, P + 1>(F, y, row, a, grp, xs);
  }
}

// y ← U⁻¹y with the upper factor, panel by panel from the last, as
// forward.
template <int NP, int GT, int P = NP / 8 - 1>
__device__ __forceinline__ void backward(const float* F, float& y, int row,
                                         int a, int grp, float* xs) {
  if constexpr (P >= 0) {
    if (row / 8 == P) {
      float f[8];
      panel_row<NP, P>(F, f);
      const float inv = F[NP];
#pragma unroll
      for (int kk = 7; kk >= 0; --kk) {
        const float xk = __shfl_sync(0xffffffffu, y * inv, 4 * kk + a);
        if (row == 8 * P + kk) y = xk;
        else if (row < 8 * P + kk) y = fmaf(-f[kk], xk, y);
      }
      xs[row] = y;
    }
    group_sync<GT>(grp);
    if (row < 8 * P) {
      float f[8];
      panel_row<NP, P>(F, f);
      const float4 lo = reinterpret_cast<const float4*>(xs + 8 * P)[0];
      const float4 hi = reinterpret_cast<const float4*>(xs + 8 * P)[1];
      y = fmaf(-f[7], hi.w, y);
      y = fmaf(-f[6], hi.z, y);
      y = fmaf(-f[5], hi.y, y);
      y = fmaf(-f[4], hi.x, y);
      y = fmaf(-f[3], lo.w, y);
      y = fmaf(-f[2], lo.z, y);
      y = fmaf(-f[1], lo.y, y);
      y = fmaf(-f[0], lo.x, y);
    }
    backward<NP, GT, P - 1>(F, y, row, a, grp, xs);
  }
}

// y ← U⁻¹y with the upper factor in this thread's register row (inv =
// 1/U[row][row]), as backward: the LU step's own factors.
template <int NP, int GT, int P = NP / 8 - 1>
__device__ __forceinline__ void backward_rows(const float (&F)[NP],
                                              float inv, float& y, int row,
                                              int a, int grp, float* xs) {
  if constexpr (P >= 0) {
    if (row / 8 == P) {
#pragma unroll
      for (int kk = 7; kk >= 0; --kk) {
        const int k = 8 * P + kk;
        const float xk = __shfl_sync(0xffffffffu, y * inv, 4 * kk + a);
        if (row == k) y = xk;
        else if (row < k) y = fmaf(-F[k], xk, y);
      }
      xs[row] = y;
    }
    group_sync<GT>(grp);
    if (row < 8 * P) {
      const float4 lo = reinterpret_cast<const float4*>(xs + 8 * P)[0];
      const float4 hi = reinterpret_cast<const float4*>(xs + 8 * P)[1];
      y = fmaf(-F[8 * P + 7], hi.w, y);
      y = fmaf(-F[8 * P + 6], hi.z, y);
      y = fmaf(-F[8 * P + 5], hi.y, y);
      y = fmaf(-F[8 * P + 4], hi.x, y);
      y = fmaf(-F[8 * P + 3], lo.w, y);
      y = fmaf(-F[8 * P + 2], lo.z, y);
      y = fmaf(-F[8 * P + 1], lo.y, y);
      y = fmaf(-F[8 * P], lo.x, y);
    }
    backward_rows<NP, GT, P - 1>(F, inv, y, row, a, grp, xs);
  }
}

// [A | R] ← Gauss-Jordan over all NP pivots, no pivoting, in the rows:
// with R = I on entry, R = A⁻¹ on exit (ops/windowed_fused.py
// lanes_invert: every row but k loses A[i,k]·(row k · 1/A[k,k]), then
// row k is scaled). Columns of A at or left of a pivot are not read
// again and are not updated; R's pivot row is zero right of the pivot.
template <int NP, int GT>
__device__ __forceinline__ void gj_invert(float (&A)[NP], float (&R)[NP],
                                          int row, int grp, float* pbuf) {
  constexpr int PB = 2 * NP + 8;   // pivot row of A and of R, two slots
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float* pb = pbuf + (k & 1) * PB;
    if (row == k) {
      const float inv = 1.0f / A[k];
#pragma unroll
      for (int j = k + 1; j < NP; ++j) A[j] = __fmul_rn(A[j], inv);
#pragma unroll
      for (int j = 0; j <= k; ++j) R[j] = __fmul_rn(R[j], inv);
#pragma unroll
      for (int q = (k + 1) / 4; q < NP / 4; ++q)
        reinterpret_cast<float4*>(pb)[q] =
            make_float4(A[4 * q], A[4 * q + 1], A[4 * q + 2], A[4 * q + 3]);
#pragma unroll
      for (int q = 0; q <= k / 4; ++q)
        reinterpret_cast<float4*>(pb + NP)[q] =
            make_float4(R[4 * q], R[4 * q + 1], R[4 * q + 2], R[4 * q + 3]);
    }
    group_sync<GT>(grp);
    if (row != k) {
      const float c = A[k];
#pragma unroll
      for (int q = (k + 1) / 4; q < NP / 4; ++q) {
        if (q % 2 == 0) load_fence();
        const float4 v = reinterpret_cast<const float4*>(pb)[q];
        if (4 * q > k) A[4 * q] = fmaf(-c, v.x, A[4 * q]);
        if (4 * q + 1 > k) A[4 * q + 1] = fmaf(-c, v.y, A[4 * q + 1]);
        if (4 * q + 2 > k) A[4 * q + 2] = fmaf(-c, v.z, A[4 * q + 2]);
        if (4 * q + 3 > k) A[4 * q + 3] = fmaf(-c, v.w, A[4 * q + 3]);
      }
#pragma unroll
      for (int q = 0; q <= k / 4; ++q) {
        if (q % 2 == 0) load_fence();
        const float4 v = reinterpret_cast<const float4*>(pb + NP)[q];
        if (4 * q <= k) R[4 * q] = fmaf(-c, v.x, R[4 * q]);
        if (4 * q + 1 <= k) R[4 * q + 1] = fmaf(-c, v.y, R[4 * q + 1]);
        if (4 * q + 2 <= k) R[4 * q + 2] = fmaf(-c, v.z, R[4 * q + 2]);
        if (4 * q + 3 <= k) R[4 * q + 3] = fmaf(-c, v.w, R[4 * q + 3]);
      }
    }
  }
}

// [A | y] ← Gauss-Jordan over the first n pivots, no pivoting, in the
// rows; returns x = A⁻¹y for this row. It is K5's elimination as the
// reference (_gauss_jordan) and K4 and K5's first designs
// (csrc/global_sweep.cu) run it, with their rounding: the pivot row k
// scaled by 1/A[k][k] (each product rounded once), then every other row
// loses A[i][k]·(scaled row k) by one fmaf a column. The owner scales its
// row and publishes it (double-buffered: one group barrier a pivot);
// the rows past n, the padded identity block, are left as they are.
template <int NP, int GT>
__device__ __forceinline__ float gj_solve(float (&A)[NP], float y, int row,
                                          int grp, float* pbuf, int n) {
  constexpr int PB = NP + 4;       // scaled pivot row, then y; two slots
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (k < n) {
      float* pb = pbuf + (k & 1) * PB;
      if (row == k) {
        const float inv = 1.0f / A[k];
#pragma unroll
        for (int j = k + 1; j < NP; ++j) A[j] = __fmul_rn(A[j], inv);
        y = __fmul_rn(y, inv);
#pragma unroll
        for (int q = (k + 1) / 4; q < NP / 4; ++q)
          reinterpret_cast<float4*>(pb)[q] =
              make_float4(A[4 * q], A[4 * q + 1], A[4 * q + 2], A[4 * q + 3]);
        pb[NP] = y;
      }
      group_sync<GT>(grp);
      if (row != k) {
        const float c = A[k];
#pragma unroll
        for (int q = (k + 1) / 4; q < NP / 4; ++q) {
          if (q % 2 == 0) load_fence();
          const float4 v = reinterpret_cast<const float4*>(pb)[q];
          if (4 * q > k) A[4 * q] = fmaf(-c, v.x, A[4 * q]);
          if (4 * q + 1 > k) A[4 * q + 1] = fmaf(-c, v.y, A[4 * q + 1]);
          if (4 * q + 2 > k) A[4 * q + 2] = fmaf(-c, v.z, A[4 * q + 2]);
          if (4 * q + 3 > k) A[4 * q + 3] = fmaf(-c, v.w, A[4 * q + 3]);
        }
        y = fmaf(-c, pb[NP], y);
      }
    }
  }
  return y;
}

template <int NP, bool CLOCKED, bool PLAIN, bool MAT = false>
__global__ void __launch_bounds__(MAT ? MatTile<NP>::TLMAX * NP
                                      : Tile<NP, PLAIN>::THREADS, 1)
serving_kernel(const Params p) {
  using T = Tile<NP, PLAIN>;
  constexpr int GT = T::GT, LD = T::LD, NQ = T::NQ;
  const int TL = MAT ? p.tl : T::TL;
  const int THREADS = TL * NP;
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, ks = p.ks;
  const int kmk8 = p.kmk8, K8 = p.K8, kfold = p.kfold, off_g = p.off_g;
  const int nth = p.nth;              // live θ rows
  const int nlive = p.nlive;          // live Bmk rows
  const int nchunk = p.nchunk, per_w = p.per_w, slot_floats = p.slot;
  const bool rich = !PLAIN && !MAT && p.solve_iters > 0;

  float* ring = smem;
  float* mat = smem + p.o_mat;        // MAT: the table ring
  float* fac = smem + p.o_fac;
  float* tps = smem + p.o_tps;
  float* ves = smem + p.o_ves;
  float* bfs = smem + p.o_bfs;
  float* lanes = smem + p.o_lanes;

  // Thread → (group, lane, row): a warp holds rows 8w'..8w'+7 of the
  // group's 4 lanes, 4 consecutive threads one row of the 4 lanes.
  const int tid = threadIdx.x;
  const int grp = tid / GT;
  const int t = tid - grp * GT;
  const int i = (t >> 5) * 8 + ((t & 31) >> 2);      // row owned
  const int a = t & 3;                               // lane of the group
  const int l = grp * GL + a;                        // lane of the tile
  const int gl = static_cast<int>(blockIdx.x) * TL + l;
  const bool valid = gl < B;
  const int glc = valid ? gl : B - 1;

  float* lv = lanes + l * p.lanef;
  float* vP = lv;                     // pred (PLAIN: u*)
  float* vPL = lv + NP;               // pred's low word
  float* vD = lv + 2 * NP;            // history difference d (PLAIN: combo)
  float* vX = lv + 3 * NP;            // δ (matvec operand)
  float* vR = lv + 4 * NP;            // Richardson residual; substitutions
  float* vCH = lv + 5 * NP;           // u (high, low)
  float* vCL = lv + 6 * NP;
  float* vC1H = lv + 7 * NP;          // the previous step's u
  float* vC1L = lv + 8 * NP;
  float* vDP = lv + 9 * NP;           // the previous step's δ
  float* pan = lv + 10 * NP;          // panel of 8 pivot rows
  float* rhs = pan + 8 * (NP + 4);    // live θ rows, then dt·b0·pred
                                      // (PLAIN: u*)
  float* thf = lv + p.o_thf;
  float* gv = lv + p.o_gv;
#define FROW (fac + (l * NP + i) * LD)   // this row's factor / K̄⁻¹ row

  // ---- the ring's mbarriers; phase clocks (thread 0) in shared ----
  // The clocks are 32-bit clock() reads and sums (a block runs far fewer
  // than 2³² cycles), kept in shared memory so that the marks add no live
  // registers to the compiled body, by the block's last thread (thread 0
  // issues the ring's copies).
  __shared__ uint64_t full_bar[STAGES];
  __shared__ uint64_t win_bar;        // the window constants' copies
  __shared__ uint64_t mat_bar[MAT ? MU_MAX : 1];   // the table ring
  __shared__ unsigned clk_sum[PHASES + 2];  // phases, total, last read
  // The block's last thread: last group, lane 3, row NP - 1.
  const bool clk_thread = CLOCKED && tid == THREADS - 1;
  if (tid == 0) {
    for (int q = 0; q < STAGES; ++q) mbar_init(&full_bar[q], 1);
    mbar_init(&win_bar, 1);
    if constexpr (MAT)
      for (int q = 0; q < MU_MAX; ++q) mbar_init(&mat_bar[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (clk_thread) {
    for (int q = 0; q <= PHASES; ++q) clk_sum[q] = 0;
    clk_sum[PHASES + 1] = clock();
  }
  __syncthreads();
#define MARK(ph)                                  \
  do {                                            \
    if constexpr (CLOCKED) {                      \
      if (clk_thread) {                           \
        const unsigned t_ = clock();              \
        const unsigned d_ = t_ - clk_sum[PHASES + 1]; \
        clk_sum[ph] += d_;                        \
        clk_sum[PHASES] += d_;                    \
        clk_sum[PHASES + 1] = t_;                 \
      }                                           \
    }                                             \
  } while (0)

  // Live row n of the segmented k-loop → its Bmk row.
  auto kidx = [&](int n) {
    return n < p.km ? n : (n < nth ? p.km8 + (n - p.km) : kmk8 + (n - nth));
  };
  // Chunk g of the ring's sequence (per window: the K̄ build under
  // Richardson, then each step's build; each build = nchunk chunks) into
  // its slot: thread 0 issues one bulk copy per θ segment the chunk
  // touches (its padded slices are contiguous), completing on the slot's
  // mbarrier.
  auto issue = [&](int g) {
    if constexpr (MAT) {
      if (nchunk == 0) return;        // no trilinear term: no T0 slices
    }
    const int w = g / per_w;
    if (tid != 0 || w >= p.W) return;
    const int n0 = (g % nchunk) * ks;
    const int n1 = min(n0 + ks, nlive);
    uint64_t* bar = &full_bar[g % STAGES];
    mbar_expect_tx(bar, (n1 - n0) * NP * LD * sizeof(float));
    float* dst = ring + (g % STAGES) * slot_floats;
    const float* src = p.Bmk + (size_t)w * kfold * NP * LD;
    for (int n = n0; n < n1;) {
      const int end = min(n < p.km ? p.km : (n < nth ? nth : nlive), n1);
      bulk_copy(dst + (n - n0) * NP * LD, src + (size_t)kidx(n) * NP * LD,
                (end - n) * NP * LD * sizeof(float), bar);
      n = end;
    }
  };
  // MAT: unit u of the table ring's sequence (step u / 2; even: the
  // block's MN tile and fN, odd: its KL tile) into slot u % mu by thread
  // 0, completing on the slot's mbarrier. The tiles of the block's valid
  // lanes are contiguous in the lane-major tables; a ragged last block
  // copies only its valid lanes (the rest are never stored).
  auto issue_mat = [&](int u) {
    if constexpr (MAT) {
      const int step = u >> 1;
      if (tid != 0 || step >= p.width) return;
      const int lane0 = static_cast<int>(blockIdx.x) * TL;
      const int nl = min(TL, B - lane0);
      uint64_t* bar = &mat_bar[u % p.mu];
      float* dst = mat + (u % p.mu) * p.mat_slot;
      const size_t row0 = (size_t)step * B + lane0;
      const unsigned tile = nl * NP * LD * sizeof(float);
      if (u & 1) {
        mbar_expect_tx(bar, tile);
        bulk_copy(dst, p.KL + row0 * NP * LD, tile, bar);
      } else {
        const unsigned fb = nl * NP * sizeof(float);
        mbar_expect_tx(bar, tile + fb);
        bulk_copy(dst, p.MN + row0 * NP * LD, tile, bar);
        bulk_copy(dst + TL * NP * LD, p.fN + row0 * NP, fb, bar);
      }
    }
  };

  float kn[NP], seg[NP];
  // kn ← bdf·MN + KL + N from the live rows of rhs, one register row; with
  // `dots`, r0 = ((MN·d + fN) − KL·pred) − N·pred, each term from its
  // segment's row as the segment ends (fN = Bf·θf with the mass fold).
  // `b` is the build's place in its window (0 the K̄ build under
  // Richardson, then one a step), which gives its chunks' place in the
  // ring's sequence.
  // Row i of unit u of the table ring (MN or KL of this thread's lane)
  // into seg, after the unit's wait and the block barrier that frees the
  // slot before it for the unit mu − 1 ahead (and publishes the step's
  // vectors).
  auto table_row = [&](int u) {
    MARK(PH_BUILD);
    mbar_wait(&mat_bar[u % p.mu], (u / p.mu) & 1);
    __syncthreads();
    issue_mat(u + p.mu - 1);
    MARK(PH_WAIT);
    const float4* row = reinterpret_cast<const float4*>(
        mat + (u % p.mu) * p.mat_slot + (l * NP + i) * LD);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q % 2 == 0) load_fence();
      const float4 v = row[q];
      seg[4 * q] = v.x;
      seg[4 * q + 1] = v.y;
      seg[4 * q + 2] = v.z;
      seg[4 * q + 3] = v.w;
    }
  };
  // MAT: kn and r0 from the step's table rows, as the mass and stiffness
  // segments' ends form them (step s: units 2s and 2s + 1).
  auto table_build = [&](int s, float bdf, float& r0) {
    table_row(2 * s);
    const float fn = mat[(2 * s % p.mu) * p.mat_slot + TL * NP * LD +
                         l * NP + i];
    MARK(PH_BUILD);
    r0 = __fadd_rn(dot_row<NP>(seg, vD), fn);
    MARK(PH_R0);
#pragma unroll
    for (int j = 0; j < NP; ++j) kn[j] = PLAIN ? seg[j] : __fmul_rn(bdf, seg[j]);
    table_row(2 * s + 1);
    if constexpr (PLAIN) {
#pragma unroll
      for (int j = 0; j < NP; ++j) kn[j] = fmaf(bdf, kn[j], seg[j]);
    } else {
      MARK(PH_BUILD);
      r0 = __fsub_rn(r0, dot_row<NP>(seg, vP));
      MARK(PH_R0);
#pragma unroll
      for (int j = 0; j < NP; ++j) kn[j] = __fadd_rn(kn[j], seg[j]);
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) seg[j] = 0.f;
  };

  auto build = [&](int w, int b, float bdf, bool dots, bool kbar,
                   float& r0) {
    int g = w * per_w + b * nchunk;
    if constexpr (MAT) {
      table_build(b, bdf, r0);
    } else {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        seg[j] = 0.f;
        kn[j] = 0.f;
      }
      r0 = 0.f;
    }
    for (int c = 0; c < nchunk; ++c, ++g) {
      if (kbar) MARK(PH_KBAR); else MARK(PH_BUILD);
      mbar_wait(&full_bar[g % STAGES], (g / STAGES) & 1);
      __syncthreads();    // slot (g-1) % STAGES is free; rhs is published
      issue(g + STAGES - 1);
      MARK(PH_WAIT);
      const float* slot = ring + (g % STAGES) * slot_floats + i * LD;
      const int n0 = c * ks;
      const int nk = min(ks, nlive - n0);
      for (int kk = 0; kk < nk; ++kk) {
        const int n = n0 + kk;
        const float cf = rhs[n];
        const float4* row = reinterpret_cast<const float4*>(slot + kk * NP * LD);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 b = row[q];
          seg[4 * q] = fmaf(b.x, cf, seg[4 * q]);
          seg[4 * q + 1] = fmaf(b.y, cf, seg[4 * q + 1]);
          seg[4 * q + 2] = fmaf(b.z, cf, seg[4 * q + 2]);
          seg[4 * q + 3] = fmaf(b.w, cf, seg[4 * q + 3]);
        }
        if (n + 1 == p.km) {                 // mass rows end: MN (r0 or bN)
          if (dots) {
            MARK(PH_BUILD);
            float fn = 0.f;
            for (int k = 0; k < p.kf8; ++k)
              fn = fmaf(bfs[k * NP + i], thf[k], fn);
            r0 = __fadd_rn(dot_row<NP>(seg, vD), fn);
            MARK(PH_R0);
          }
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            kn[j] = PLAIN ? seg[j] : __fmul_rn(bdf, seg[j]);
            seg[j] = 0.f;
          }
        } else if (n + 1 == nth || n + 1 == nlive) {  // KL, then N
          if constexpr (PLAIN) {
            // K5's rounding (csrc/global_sweep.cu): KN = fmaf(bdf, MN, KL),
            // then KN = fmaf(N, dt·b0, KN) with N = T0·u* unscaled.
            if (n + 1 == nth) {
#pragma unroll
              for (int j = 0; j < NP; ++j) kn[j] = fmaf(bdf, kn[j], seg[j]);
            } else {
              const float dtb = __fmul_rn(p.dt, __ldg(&p.b0[glc]));
#pragma unroll
              for (int j = 0; j < NP; ++j) kn[j] = fmaf(seg[j], dtb, kn[j]);
            }
#pragma unroll
            for (int j = 0; j < NP; ++j) seg[j] = 0.f;
          } else {
            if (dots) {
              MARK(PH_BUILD);
              r0 = __fsub_rn(r0, dot_row<NP>(seg, vP));
              MARK(PH_R0);
            }
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              kn[j] = __fadd_rn(kn[j], seg[j]);
              seg[j] = 0.f;
            }
          }
        }
      }
    }
  };

  // ---- the dd carry and δ in this row's entries of vCH/vCL (u),
  //      vC1H/vC1L (the previous u) and vDP; the PLAIN step starts from
  //      zero and keeps no low words ----
  if constexpr (PLAIN) {
    vCH[i] = vCL[i] = vC1H[i] = vC1L[i] = 0.f;
  } else {
    vCH[i] = p.state0[(0 * NP + i) * B + glc];
    vCL[i] = p.state0[(1 * NP + i) * B + glc];
    vC1H[i] = p.state0[(2 * NP + i) * B + glc];
    vC1L[i] = p.state0[(3 * NP + i) * B + glc];
  }
  vDP[i] = 0.f;
  for (int q = 0; q < STAGES - 1; ++q) issue(q);
  if constexpr (MAT)
    for (int q = 0; q < p.mu - 1; ++q) issue_mat(q);

  for (int w = 0; w < p.W; ++w) {
    // ---- window constants: Tp (with the boundary transfer only), VE
    //      (rows padded by the wrapper), Bf, by bulk copies of thread 0 ----
    const bool boundary = !PLAIN && !MAT && p.boundary;
    __syncthreads();    // the previous window's constants are read
    if (tid == 0) {
      mbar_expect_tx(&win_bar, ((boundary ? NP : 0) * LD + PROBE_P * LD +
                                p.kf8 * NP) * sizeof(float));
      if (boundary)
        bulk_copy(tps, p.Tp + (size_t)w * NP * LD, NP * LD * sizeof(float),
                  &win_bar);
      bulk_copy(ves, p.VE + (size_t)w * PROBE_P * LD,
                PROBE_P * LD * sizeof(float), &win_bar);
      if (p.kf8 > 0)
        bulk_copy(bfs, p.Bf + (size_t)w * p.kf8 * NP,
                  p.kf8 * NP * sizeof(float), &win_bar);
    }
    mbar_wait(&win_bar, w & 1);

    // ---- boundary: dd transfer of both registers through T_w, plain
    //      transfer of δ under Richardson ----
    if (boundary) {
      float oh, ol, o1h, o1l, od = 0.f;
      dd_matvec_row<NP>(tps + i * LD, vCH, vCL, oh, ol);
      load_fence();
      dd_matvec_row<NP>(tps + i * LD, vC1H, vC1L, o1h, o1l);
      if (rich) od = dot_shared<NP>(tps + i * LD, vDP);
      group_sync<GT>(grp);
      vCH[i] = oh;
      vCL[i] = ol;
      vC1H[i] = o1h;
      vC1L[i] = o1l;
      vDP[i] = od;
    }
    MARK(PH_BOUNDARY);

    // ---- Richardson window start: K̄ = Bmk·[THbar_w; dt·b0·u], its
    //      inverse's rows → fac ----
    if (rich) {
      const float* thb = p.THbar + (size_t)w * kmk8 * B;
      for (int n = i; n < nth; n += NP)
        rhs[n] = __ldg(&thb[(size_t)kidx(n) * B + glc]);
      if (p.with_tri)
        rhs[nth + i] = __fmul_rn(vCH[i], __fmul_rn(p.dt, __ldg(&p.b0[glc])));
      float unused;
      build(w, 0, 1.0f, false, true, unused);
#pragma unroll
      for (int j = 0; j < NP; ++j) seg[j] = j == i ? 1.f : 0.f;
      gj_invert<NP, GT>(kn, seg, i, grp, pan);
      store_row<NP>(FROW, seg);
      MARK(PH_KBAR);
    }

    for (int s = 0; s < p.width; ++s) {
      const int step = w * p.width + s;
      const float* th = p.TH + (size_t)step * K8 * B;
      const bool first = !p.bdf2 || p.step0 + step == 0;
      const float bdf = first ? 1.0f : 1.5f;

      // ---- predictor, right-hand side rows ----
      group_sync<GT>(grp);
      if constexpr (PLAIN) {
        // u* = 2u − u₋₁ and combo = 2u − ½u₋₁ (BDF-1: u, u), each one
        // rounding as in the reference (the products by 2 and ½ are
        // exact).
        const float u = vCH[i], u1 = vC1H[i];
        float us = u, cb = u;
        if (p.bdf2) {
          us = __fsub_rn(__fmul_rn(2.0f, u), u1);
          cb = __fsub_rn(__fmul_rn(2.0f, u), __fmul_rn(0.5f, u1));
        }
        vP[i] = us;
        vD[i] = cb;
        if (p.with_tri) rhs[nth + i] = us;   // N = T0·u*, scaled after
      } else {
        float ph = vCH[i], pl = vCL[i], d = 0.f;
        if (!first) dd_predict(vCH[i], vCL[i], vC1H[i], vC1L[i], ph, pl, d);
        vP[i] = ph;
        vPL[i] = pl;
        vD[i] = d;
        if (p.with_tri)
          rhs[nth + i] = __fmul_rn(ph, __fmul_rn(p.dt, __ldg(&p.b0[glc])));
      }
      for (int n = i; n < nth; n += NP)
        rhs[n] = __ldg(&th[(size_t)kidx(n) * B + glc]);
      for (int k = i; k < p.kf8; k += NP)
        thf[k] = __ldg(&th[(size_t)(kmk8 + k) * B + glc]);
      if (i < PROBE_P) gv[i] = __ldg(&th[(size_t)(off_g + i) * B + glc]);

      // ---- KN and r0 (the build's barriers publish rhs and θf) ----
      float r0;
      build(w, s + (rich ? 1 : 0), bdf, true, false, r0);
      MARK(PH_BUILD);

      // ---- solve KN·δ = r0 (PLAIN: KN·u = bN) ----
      float x;      // δ; PLAIN: the new u
      if constexpr (PLAIN) {
        x = gj_solve<NP, GT>(kn, r0, i, grp, pan, p.n_real);
      } else if (rich) {
        // δ ← δ + K̄⁻¹(r0 − KN·δ) from the previous δ, K̄⁻¹'s row read as
        // float4s from shared memory against the KN row in registers.
        x = vDP[i];
        for (int it = 0; it < p.solve_iters; ++it) {
          vX[i] = x;
          group_sync<GT>(grp);
          const float res = __fsub_rn(r0, dot_row<NP>(kn, vX));
          vR[i] = res;
          group_sync<GT>(grp);
          x = __fadd_rn(x, dot_shared<NP>(FROW, vR));
        }
        vDP[i] = x;
      } else {
        // The tables' steps (MAT) take the per-step LU: K2 pairs none.
        const int role = MAT ? 0 : step_role(s % p.period, p.period, p.group);
        if (!MAT && role == 2) {
          // sub1 follower: substitute with the leader's factors, then one
          // refinement against this step's own KN.
          float y = r0;
          forward<NP, GT>(FROW, y, i, a, grp, vR);
          backward<NP, GT>(FROW, y, i, a, grp, vR);
          vX[i] = y;
          group_sync<GT>(grp);
          float e = __fsub_rn(r0, dot_row<NP>(kn, vX));
          forward<NP, GT>(FROW, e, i, a, grp, vR);
          backward<NP, GT>(FROW, e, i, a, grp, vR);
          x = __fadd_rn(y, e);
        } else {
          // A leader's factor row goes to its slot for the followers.
          float y = r0, inv;
          eliminate<NP, GT>(kn, y, inv, i, grp, pan);
          if (!MAT && role == 1) {
            store_row<NP>(FROW, kn);
            FROW[NP] = inv;
          }
          backward_rows<NP, GT>(kn, inv, y, i, a, grp, vR);
          x = y;
        }
      }
      MARK(PH_SOLVE);

      // ---- u = pred ⊕ δ (dd add; PLAIN: u = x), shift history, probes ----
      if constexpr (PLAIN) {
        vC1H[i] = vCH[i];
        vCH[i] = x;
      } else {
        float nh, nl;
        dd_add_small(vP[i], vPL[i], x, nh, nl);
        vC1H[i] = vCH[i];
        vC1L[i] = vCL[i];
        vCH[i] = nh;
        vCL[i] = nl;
      }
      group_sync<GT>(grp);
      if (i < PROBE_P) {
        const float acc = dot_shared<NP>(ves + i * LD, vCH);
        if (valid)
          p.probes[((size_t)step * PROBE_P + i) * B + gl] = __fadd_rn(acc, gv[i]);
      }
      MARK(PH_UPDATE);
    }
  }

  if (valid && PLAIN) {
    p.state[(size_t)i * B + gl] = vCH[i];
  } else if (valid) {
    p.state[(0 * NP + i) * B + gl] = vCH[i];
    p.state[(1 * NP + i) * B + gl] = vCL[i];
    p.state[(2 * NP + i) * B + gl] = vC1H[i];
    p.state[(3 * NP + i) * B + gl] = vC1L[i];
  }
  if constexpr (CLOCKED) {
    if (clk_thread) {
      MARK(PH_UPDATE);
      long long* out = p.clk + (size_t)blockIdx.x * (PHASES + 1);
      for (int q = 0; q <= PHASES; ++q) out[q] = (long long)clk_sum[q];
    }
  }
#undef MARK
#undef FROW
}

// Chunk size: the largest ks ≤ KS_MAX whose shared memory fits (0: none).
template <int NP, bool PLAIN>
int pick_ks(int kmk8, int kf8) {
  for (int ks = KS_MAX; ks >= 1; --ks)
    if (smem_floats(NP, Tile<NP, PLAIN>::TL, ks, kmk8, kf8) * sizeof(float) <=
        SMEM_LIMIT)
      return ks;
  return 0;
}

// The derived sizes and shared-memory offsets of Params (floats).
template <int NP, bool PLAIN>
void set_shape(Params& p) {
  constexpr int LD = Tile<NP>::LD, TL = Tile<NP, PLAIN>::TL;
  p.kmk8 = p.km8 + p.kk8;
  p.K8 = p.kmk8 + p.kf8 + PROBE_P;
  p.kfold = p.kmk8 + (p.with_tri ? NP : 0);
  p.off_g = p.kmk8 + p.kf8;
  p.nth = p.km + p.kk;
  p.nlive = p.nth + (p.with_tri ? NP : 0);
  p.nchunk = (p.nlive + p.ks - 1) / p.ks;
  p.per_w = (p.width + (p.solve_iters > 0 ? 1 : 0)) * p.nchunk;
  p.slot = p.ks * NP * LD;
  p.o_fac = STAGES * p.slot;
  p.o_tps = p.o_fac + TL * NP * LD;
  p.o_ves = p.o_tps + NP * LD;
  p.o_bfs = p.o_ves + PROBE_P * LD;
  p.o_lanes = p.o_bfs + round4(p.kf8) * NP;
  p.lanef = lane_floats(NP, p.kmk8, p.kf8);
  p.o_thf = 10 * NP + 8 * (NP + 4) + round4(p.kmk8 + NP);
  p.o_gv = p.o_thf + round4(p.kf8);
}

template <int NP, bool CLOCKED, bool PLAIN>
cudaError_t launch_np(Params p, cudaStream_t stream) {
  using T = Tile<NP, PLAIN>;
  const int kmk8 = p.km8 + p.kk8;
  p.ks = pick_ks<NP, PLAIN>(kmk8, p.kf8);
  if (p.ks < 1) return cudaErrorInvalidValue;
  set_shape<NP, PLAIN>(p);
  const size_t bytes = smem_floats(NP, T::TL, p.ks, kmk8, p.kf8) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      serving_kernel<NP, CLOCKED, PLAIN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int grid = (p.B + T::TL - 1) / T::TL;
  serving_kernel<NP, CLOCKED, PLAIN><<<grid, T::THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The launch shape for NP and the θ extents: out = (lanes a block,
// threads a block, k-slices a chunk, shared bytes).
template <int NP, bool PLAIN>
void tile_of(int kmk8, int kf8, int* out) {
  using T = Tile<NP, PLAIN>;
  out[0] = T::TL;
  out[1] = T::THREADS;
  out[2] = pick_ks<NP, PLAIN>(kmk8, kf8);
  out[3] = (int)(smem_floats(NP, T::TL, out[2], kmk8, kf8) * sizeof(float));
}

// tile_of for a runtime NP (a multiple of 8 in 8..64); returns 0, or
// cudaErrorInvalidValue for an NP it does not take.
template <bool PLAIN>
int tile_for(int NP, int km8, int kk8, int kf8, int* out) {
  const int kmk8 = km8 + kk8;
  switch (NP) {
    case 8: tile_of<8, PLAIN>(kmk8, kf8, out); break;
    case 16: tile_of<16, PLAIN>(kmk8, kf8, out); break;
    case 24: tile_of<24, PLAIN>(kmk8, kf8, out); break;
    case 32: tile_of<32, PLAIN>(kmk8, kf8, out); break;
    case 40: tile_of<40, PLAIN>(kmk8, kf8, out); break;
    case 48: tile_of<48, PLAIN>(kmk8, kf8, out); break;
    case 56: tile_of<56, PLAIN>(kmk8, kf8, out); break;
    case 64: tile_of<64, PLAIN>(kmk8, kf8, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// ---- the materialized source (MAT): K2 and K4 ----

// Shared floats of a MAT block: the T0 ring (ks slices a chunk, none
// without the trilinear term), the table ring (mu units of the TL lanes'
// tile and fN), VE and the lanes' scratch (no θ rows, no factor slot).
inline size_t mat_smem_floats(int NP, int tl, int ks, int mu) {
  const int LD = NP + 4;
  return (size_t)STAGES * ks * NP * LD + (size_t)mu * tl * NP * (LD + 1)
         + (size_t)PROBE_P * LD + (size_t)tl * lane_floats(NP, 0, 0);
}

// The table ring's depth and the T0 chunk: mu = 3 (the next step's MN a
// whole step ahead) when it fits beside a chunk of at least one slice,
// else 2; ks the largest ≤ min(KS_MAX, NP) that fits (0 without the
// trilinear term). Returns false when nothing fits.
inline bool pick_mat(int NP, int tl, bool with_tri, int* mu, int* ks) {
  for (int m = MU_MAX; m >= 2; --m) {
    if (!with_tri) {
      if (mat_smem_floats(NP, tl, 0, m) * sizeof(float) <= SMEM_LIMIT) {
        *mu = m;
        *ks = 0;
        return true;
      }
      continue;
    }
    for (int k = min(KS_MAX, NP); k >= 1; --k)
      if (mat_smem_floats(NP, tl, k, m) * sizeof(float) <= SMEM_LIMIT) {
        *mu = m;
        *ks = k;
        return true;
      }
  }
  return false;
}

inline bool mat_lanes_ok(int NP, int tl, int tlmax) {
  return (tl == 4 || tl == 8 || tl == 16) && tl <= tlmax && NP % 8 == 0;
}

// The derived sizes and offsets of Params for a MAT launch: one window of
// `width` steps; TH is g (K8 = PROBE_P, no θ rows), the Bmk ring streams
// the T0 fold (kfold = NP) alone.
template <int NP>
void set_shape_mat(Params& p) {
  constexpr int LD = NP + 4;
  p.km8 = p.kk8 = p.kf8 = p.km = p.kk = 0;
  p.kmk8 = 0;
  p.K8 = PROBE_P;
  p.kfold = p.with_tri ? NP : 0;
  p.off_g = 0;
  p.nth = 0;
  p.nlive = p.with_tri ? NP : 0;
  p.nchunk = p.ks > 0 ? (p.nlive + p.ks - 1) / p.ks : 0;
  p.per_w = p.width * p.nchunk;
  p.slot = p.ks * NP * LD;
  p.o_mat = STAGES * p.slot;
  p.mat_slot = p.tl * NP * (LD + 1);
  p.o_fac = p.o_tps = p.o_ves = p.o_mat + p.mu * p.mat_slot;
  p.o_bfs = p.o_lanes = p.o_ves + PROBE_P * LD;
  p.lanef = lane_floats(NP, 0, 0);
  p.o_thf = 10 * NP + 8 * (NP + 4) + round4(NP);
  p.o_gv = p.o_thf;
}

template <int NP, bool CLOCKED, bool PLAIN>
cudaError_t launch_mat_np(Params p, cudaStream_t stream) {
  if (!mat_lanes_ok(NP, p.tl, MatTile<NP>::TLMAX) ||
      !pick_mat(NP, p.tl, p.with_tri, &p.mu, &p.ks))
    return cudaErrorInvalidValue;
  set_shape_mat<NP>(p);
  const size_t bytes = mat_smem_floats(NP, p.tl, p.ks, p.mu) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      serving_kernel<NP, CLOCKED, PLAIN, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int grid = (p.B + p.tl - 1) / p.tl;
  serving_kernel<NP, CLOCKED, PLAIN, true>
      <<<grid, p.tl * NP, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The MAT launch shape for NP and `tl` lanes a block: out = (lanes a
// block, threads a block, T0 slices a chunk, shared bytes, table ring
// units, the largest lanes a block at this NP); returns 0, or
// cudaErrorInvalidValue for a shape it does not take.
inline int mat_tile_for(int NP, int tl, int with_tri, int* out) {
  int tlmax;
  switch (NP) {
    case 8: tlmax = MatTile<8>::TLMAX; break;
    case 16: tlmax = MatTile<16>::TLMAX; break;
    case 24: tlmax = MatTile<24>::TLMAX; break;
    case 32: tlmax = MatTile<32>::TLMAX; break;
    case 40: tlmax = MatTile<40>::TLMAX; break;
    case 48: tlmax = MatTile<48>::TLMAX; break;
    case 56: tlmax = MatTile<56>::TLMAX; break;
    case 64: tlmax = MatTile<64>::TLMAX; break;
    default: return (int)cudaErrorInvalidValue;
  }
  int mu = 0, ks = 0;
  if (!mat_lanes_ok(NP, tl, tlmax) || !pick_mat(NP, tl, with_tri, &mu, &ks))
    return (int)cudaErrorInvalidValue;
  out[0] = tl;
  out[1] = tl * NP;
  out[2] = ks;
  out[3] = (int)(mat_smem_floats(NP, tl, ks, mu) * sizeof(float));
  out[4] = mu;
  out[5] = tlmax;
  return 0;
}

}  // namespace
