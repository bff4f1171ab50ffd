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
// Instantiations: the dd step at NP 8..32 here, CLOCKED at NP 32 (a
// measurement, and each instantiation adds to the build); NP 40 and 48
// (CLOCKED at 48) in csrc/windowed_serving_np48.cu and NP 56 and 64 in
// csrc/windowed_serving_np64.cu, translation units of their own so that
// the three build in parallel (ops/windowed_fused.py serving_library
// picks one by NP). The C entries are in csrc/windowed_serving_entries.cuh.
// K5's plain-f32 step form of the same body is instantiated in
// csrc/global_serving.cu, likewise its own unit.

#include "serving_body.cuh"

namespace {

cudaError_t launch(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 8: return launch_np<8, false, false>(p, s);
    case 16: return launch_np<16, false, false>(p, s);
    case 24: return launch_np<24, false, false>(p, s);
    case 32: return launch_np<32, false, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_clocked(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 32: return launch_np<32, true, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#include "windowed_serving_entries.cuh"
