// Windowed serving sweeps on the serving body (csrc/serving_body.cuh),
// for Hopper (sm_90a): K1's serving design and K3.
//
// Replaces, in romtime_tpu/ops/pallas_online.py,
// - _windowed_fused_kernel (K1) on the serving path of
//   online_sweep_windowed_fused: the serving options only (the per-step
//   LU, the paired LU with `sub1` followers, the Richardson solve;
//   ops/windowed_fused.py routes by option: the other follower modes and
//   the ablations stay on the first design, csrc/windowed_fused.cu). The
//   whole W-window BDF-2 trajectory of a μ batch in one launch, the
//   double-f32 (dd) carry with dd boundary transfers, per step KN·δ = r0
//   by a pivot-free solve, probes per step;
// - _theta_sweep_kernel_v2 (K3, behind online_sweep_theta_pallas_v2):
//   the same dd residual step, one window of nt steps from global step
//   step0 (W = 1, width = nt), the carry taken as it comes (the engine
//   transfers it through T_w between launches) and returned, so per-window
//   launches chain. Its first design (csrc/resid_sweep.cu) stays as the
//   yardstick.
//
// What bounds them on this card: operations. Per lane-step the solve
// matrix KN = Bmk·rhs over the live θ rows (NP²·(km + kk + NP) FMAs: 57k
// at 50x32), three NP² matvecs, fN and the solve (~12k at 50x32), against
// (K8 + 8)·4 bytes of θ and probe streams. The design (the serving body)
// is described in csrc/serving_body.cuh.
//
// Instantiations: the dd step at NP 8..64 (the served kernels), CLOCKED at
// NP 32 and 48 (the fleet's two padded widths; a measurement, and each
// instantiation adds to the build). K5's plain-f32 step form of the same
// body is instantiated in csrc/global_serving.cu, its own translation
// unit, so that the two build in parallel.

#include "serving_body.cuh"

namespace {

cudaError_t launch(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 8: return launch_np<8, false, false>(p, s);
    case 16: return launch_np<16, false, false>(p, s);
    case 24: return launch_np<24, false, false>(p, s);
    case 32: return launch_np<32, false, false>(p, s);
    case 40: return launch_np<40, false, false>(p, s);
    case 48: return launch_np<48, false, false>(p, s);
    case 56: return launch_np<56, false, false>(p, s);
    case 64: return launch_np<64, false, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_clocked(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 32: return launch_np<32, true, false>(p, s);
    case 48: return launch_np<48, true, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int NP, int B, int km8, int kk8, int km, int kk) {
  return NP % 8 != 0 || NP < 8 || NP > 64 || B < 1 || km < 1 || km > km8 ||
         kk < 1 || kk > kk8;
}

}  // namespace

extern "C" {

// Launch K1's serving design on `stream`; returns the cudaError_t of the
// launch (0 = ok). Bmk is (W, kfold, NP, NP + 4), Tp (W, NP, NP + 4) and
// VE (W, PROBE_P, NP + 4), their rows padded. `clk` (int64, grid ×
// (PHASES + 1)) non-null launches the CLOCKED instantiation (NP 32 and 48
// only). group ≥ 2 pairs the LU with sub1 followers; solve_iters > 0 runs
// the Richardson solve (and no pairing).
int romtime_windowed_serving(const float* TH, const float* Bmk,
                             const float* Bf, const float* VE,
                             const float* Tp, const float* b0,
                             const float* state0, const float* THbar,
                             float* probes, float* state, long long* clk,
                             int W, int width, int period, int NP, int B,
                             int km8, int kk8, int kf8, int km, int kk,
                             int with_tri, int bdf2, int group,
                             int solve_iters, float dt, void* stream) {
  if (solve_iters > 0) group = 0;
  if (bad_shape(NP, B, km8, kk8, km, kk) || solve_iters < 0 || period < 1)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.TH = TH; p.Bmk = Bmk; p.Bf = Bf; p.VE = VE; p.Tp = Tp; p.b0 = b0;
  p.state0 = state0; p.THbar = THbar; p.probes = probes; p.state = state;
  p.clk = clk;
  p.W = W; p.width = width; p.period = period; p.B = B;
  p.km8 = km8; p.kk8 = kk8; p.kf8 = kf8; p.km = km; p.kk = kk;
  p.with_tri = with_tri; p.bdf2 = bdf2; p.group = group;
  p.solve_iters = solve_iters; p.step0 = 0; p.boundary = 1; p.dt = dt;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(clk ? launch_clocked(p, NP, s) : launch(p, NP, s));
}

// Launch K3 on the serving body: one window of nt steps from global step
// step0, the dd carry state0 (4, NP, B) in and state out, no transfer.
// TH is the merged (nt, km8 + kk8 + kf8 + PROBE_P, B) table
// [θm | θk | θf | g], Bmk (1, kfold, NP, NP + 4) and VE (1, PROBE_P,
// NP + 4) with their rows padded, Bf (1, kf8, NP); km and kk are the
// live θm and θk rows. `clk` as for K1.
int romtime_theta_resid_serving(const float* TH, const float* Bmk,
                                const float* Bf, const float* VE,
                                const float* b0, const float* state0,
                                float* probes, float* state, long long* clk,
                                int nt, int NP, int B, int km8, int kk8,
                                int kf8, int km, int kk, int step0,
                                int with_tri, int bdf2, float dt,
                                void* stream) {
  if (bad_shape(NP, B, km8, kk8, km, kk) || nt < 1 || step0 < 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.TH = TH; p.Bmk = Bmk; p.Bf = Bf; p.VE = VE; p.b0 = b0;
  p.state0 = state0; p.probes = probes; p.state = state; p.clk = clk;
  p.W = 1; p.width = nt; p.period = nt; p.B = B;
  p.km8 = km8; p.kk8 = kk8; p.kf8 = kf8; p.km = km; p.kk = kk;
  p.with_tri = with_tri; p.bdf2 = bdf2; p.step0 = step0; p.boundary = 0;
  p.dt = dt;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(clk ? launch_clocked(p, NP, s) : launch(p, NP, s));
}

// The launch shape for NP and the θ extents: out = (lanes a block,
// threads a block, k-slices a chunk, shared bytes); returns 0, or
// cudaErrorInvalidValue for an NP it does not take.
int romtime_windowed_serving_tile(int NP, int km8, int kk8, int kf8,
                                  int* out) {
  return tile_for<false>(NP, km8, kk8, kf8, out);
}

const char* romtime_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
