// Global-basis sweep K4 on the serving body (csrc/serving_body.cuh), its
// operators read from materialized tables, for Hopper (sm_90a).
//
// Replaces romtime_tpu/ops/pallas_online.py::_sweep_kernel (K4, behind
// online_sweep_pallas): the whole plain-f32 sweep of the reference's
// _bdf_step from a zero state,
//
//   u* = 2·uN − uN₋₁,  combo = 2·uN − ½·uN₋₁   (BDF-2; BDF-1: uN, uN)
//   KN = fmaf(bdf, MN, KL), then fmaf(T0·u*, dt·b0, KN)   (trilinear, opt.)
//   bN = MN·combo + fN
//   uN = Gauss-Jordan(KN, bN)        (pivot-free, the n_real rows in order)
//   probes = VE·uN + g
//
// with MN, KL and fN read per step from the engine's materialized
// tables. It is the serving body's PLAIN step over the materialized
// source (MAT), in K4's rounding and K5's Gauss-Jordan, so the served K5
// (the same PLAIN step over θ) agrees with it as the two first designs
// did. The padded block of KN is the identity, so the padded rows of uN
// and of the probes stay exact 0. The first design (csrc/global_sweep.cu)
// stays as the yardstick.
//
// What bounds it on this card: bytes in principle (2·NP·(NP + 4)·4 +
// NP·4 bytes of tables a lane-step, 2.6 KB at NP 16, against NP³ FMAs of
// the trilinear term and the n·NP² of the elimination), in practice the
// Gauss-Jordan's chain of n_real group barriers a step.
//
// Layout: MN, KL (nt, B, NP, NP + 4) and fN (nt, B, NP), lane-major with
// the body's row padding (ops/global_sweep.py converts the reference's
// layout; the engine hands these tables down directly). The lanes a
// block (4, 8 or 16) are chosen by the wrapper from the batch: 16 at
// B=2048, NP 16, 128 blocks.
//
// Instantiations: NP 8..64 (the served kernels) and CLOCKED at NP 16 (the
// throughput ROM's padded width, N=15). Its own translation unit, so that
// it builds in parallel with the other serving-body sources.

#include "serving_body.cuh"

namespace {

cudaError_t launch(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 8: return launch_mat_np<8, false, true>(p, s);
    case 16: return launch_mat_np<16, false, true>(p, s);
    case 24: return launch_mat_np<24, false, true>(p, s);
    case 32: return launch_mat_np<32, false, true>(p, s);
    case 40: return launch_mat_np<40, false, true>(p, s);
    case 48: return launch_mat_np<48, false, true>(p, s);
    case 56: return launch_mat_np<56, false, true>(p, s);
    case 64: return launch_mat_np<64, false, true>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_clocked(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 16: return launch_mat_np<16, true, true>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K4 on the serving body on `stream`; returns the cudaError_t of
// the launch (0 = ok). MN, KL (nt, B, NP, NP + 4) and fN (nt, B, NP)
// lane-major, g (nt, PROBE_P, B), T0 the fold (1, NP, NP, NP + 4) and VE
// (1, PROBE_P, NP + 4) with their rows padded, b0 (1, B); n_real the
// Gauss-Jordan's pivots, `tl` lanes a block. Writes probes
// (nt, PROBE_P, B) and uN (NP, B). `clk` (int64, grid × (PHASES + 1))
// non-null launches the CLOCKED instantiation (NP 16 only).
int romtime_global_tables_serving(const float* MN, const float* KL,
                                  const float* fN, const float* g,
                                  const float* T0, const float* VE,
                                  const float* b0, float* probes, float* uN,
                                  long long* clk, int nt, int NP, int B,
                                  int tl, int n_real, int with_tri, int bdf2,
                                  float dt, void* stream) {
  if (NP % 8 != 0 || NP < 8 || NP > 64 || B < 1 || nt < 1 || n_real < 1 ||
      n_real > NP)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.TH = g; p.Bmk = T0; p.VE = VE; p.b0 = b0;
  p.probes = probes; p.state = uN; p.clk = clk;
  p.MN = MN; p.KL = KL; p.fN = fN; p.tl = tl;
  p.W = 1; p.width = nt; p.period = nt; p.B = B;
  p.with_tri = with_tri; p.bdf2 = bdf2; p.step0 = 0; p.boundary = 0;
  p.n_real = n_real; p.dt = dt;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(clk ? launch_clocked(p, NP, s) : launch(p, NP, s));
}

const char* romtime_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
