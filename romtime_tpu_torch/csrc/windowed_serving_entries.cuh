// The C entries of K1's serving design and K3 on the serving body,
// shared by the translation units that instantiate the dd step
// (csrc/windowed_serving.cu, csrc/windowed_serving_np48.cu,
// csrc/windowed_serving_np64.cu), each for its own NP. A unit defines
// launch(p, NP, s) and launch_clocked(p, NP, s) for its NP (any other NP
// returns cudaErrorInvalidValue) and then includes this header.

#pragma once

namespace {

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
