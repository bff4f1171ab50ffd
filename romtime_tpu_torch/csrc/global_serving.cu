// Global-basis θ-streaming sweep K5 on the serving body
// (csrc/serving_body.cuh), for Hopper (sm_90a).
//
// Replaces romtime_tpu/ops/pallas_online.py::_theta_sweep_kernel (K5,
// behind online_sweep_theta_pallas): the whole plain-f32 sweep of the
// reference's _bdf_step from a zero state,
//
//   u* = 2·uN − uN₋₁,  combo = 2·uN − ½·uN₋₁   (BDF-2; BDF-1: uN, uN)
//   KN = bdf·MN + KL + (T0·u*)·dt·b0             (trilinear, optional)
//   bN = MN·combo + fN
//   uN = Gauss-Jordan(KN, bN)        (pivot-free, the n_real rows in order)
//   probes = VE·uN + g
//
// with MN = Bm·θm, KL = Bk·θk and fN = Bf·θf formed per step in the
// kernel. It is the serving body's PLAIN step form: one window of nt
// steps (W = 1, width = nt), no boundary transfer, the carry plain f32
// with no low words, uN (NP, B) written at the end. Every sum, product
// and the Gauss-Jordan are rounded as in K4 and K5's first designs, so
// the served K5 agrees with K4 as closely as those two agree; the padded
// block of KN is the identity, and the padded rows of uN and of the
// probes stay exact 0. The first design (csrc/global_sweep.cu) stays as
// the yardstick.
//
// What bounds it on this card: operations. Per lane-step NP²·(km + kk +
// NP) FMAs for KN (3.7e4 at N=20, NP 24), the MN·combo dot, fN and the
// Gauss-Jordan (one group barrier a pivot), against (K8 + 8)·4 bytes of
// θ and probe streams and NP·4 bytes of uN. The design is described in csrc/serving_body.cuh; the tile at
// NP ≤ 16 takes 16 lanes a block so that B=2048 gives 128 blocks.
//
// Instantiations: NP 8..64 (the served kernels), and CLOCKED at NP 24
// (the S-ROM's padded width, N=20) for the phase clocks. Its own
// translation unit, so that it builds in parallel with
// csrc/windowed_serving.cu.

#include "serving_body.cuh"

namespace {

cudaError_t launch(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 8: return launch_np<8, false, true>(p, s);
    case 16: return launch_np<16, false, true>(p, s);
    case 24: return launch_np<24, false, true>(p, s);
    case 32: return launch_np<32, false, true>(p, s);
    case 40: return launch_np<40, false, true>(p, s);
    case 48: return launch_np<48, false, true>(p, s);
    case 56: return launch_np<56, false, true>(p, s);
    case 64: return launch_np<64, false, true>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_clocked(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 24: return launch_np<24, true, true>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K5 on the serving body on `stream`; returns the cudaError_t of
// the launch (0 = ok). TH is the merged (nt, km8 + kk8 + kf8 + PROBE_P, B)
// table [θm | θk | θf | g], Bmk (1, kfold, NP, NP + 4) and VE (1, PROBE_P,
// NP + 4) with their rows padded, Bf (1, kf8, NP); km and kk are the live
// θm and θk rows, n_real the Gauss-Jordan's pivots. Writes probes
// (nt, PROBE_P, B) and uN (NP, B). `clk` (int64, grid × (PHASES + 1))
// non-null launches the CLOCKED instantiation (NP 24 only).
int romtime_theta_global_serving(const float* TH, const float* Bmk,
                                 const float* Bf, const float* VE,
                                 const float* b0, float* probes, float* uN,
                                 long long* clk, int nt, int NP, int B,
                                 int km8, int kk8, int kf8, int km, int kk,
                                 int n_real, int with_tri, int bdf2,
                                 float dt, void* stream) {
  if (NP % 8 != 0 || NP < 8 || NP > 64 || B < 1 || nt < 1 || km < 1 ||
      km > km8 || kk < 1 || kk > kk8 || n_real < 1 || n_real > NP)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.TH = TH; p.Bmk = Bmk; p.Bf = Bf; p.VE = VE; p.b0 = b0;
  p.probes = probes; p.state = uN; p.clk = clk;
  p.W = 1; p.width = nt; p.period = nt; p.B = B;
  p.km8 = km8; p.kk8 = kk8; p.kf8 = kf8; p.km = km; p.kk = kk;
  p.with_tri = with_tri; p.bdf2 = bdf2; p.step0 = 0; p.boundary = 0;
  p.n_real = n_real; p.dt = dt;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(clk ? launch_clocked(p, NP, s) : launch(p, NP, s));
}

// The launch shape for NP and the θ extents: out = (lanes a block,
// threads a block, k-slices a chunk, shared bytes); returns 0, or
// cudaErrorInvalidValue for an NP it does not take.
int romtime_global_serving_tile(int NP, int km8, int kk8, int kf8,
                                int* out) {
  return tile_for<true>(NP, km8, kk8, kf8, out);
}

const char* romtime_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
