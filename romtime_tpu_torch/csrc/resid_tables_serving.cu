// Residual-form sweep K2 on the serving body (csrc/serving_body.cuh), its
// operators read from materialized tables, for Hopper (sm_90a).
//
// Replaces romtime_tpu/ops/pallas_online.py::_sweep_kernel_v2 (K2, behind
// online_sweep_pallas_v2): one window of nt steps of the residual-form dd
// BDF step (_bdf_step_resid) from global step step0,
//
//   pred, d = dd BDF-2 predictor of the double-f32 carry (BDF-1 at global
//             step 0)
//   KN   = bdf·MN + KL + N,  N = T0·(dt·b0·pred)        (trilinear, optional)
//   r0   = MN·d + fN − KL·pred − N·pred
//   KN·δ = r0 (pivot-free LU),  u = pred ⊕ δ (dd add),  probes = VE·u + g
//
// with MN, KL and fN read per step from the engine's materialized
// tables. It is the serving body's dd step over the materialized source
// (MAT): the carry comes in (state0) and goes out (state), no transfer
// (the engine applies T_w between launches), so per-window launches
// chain. The first design (csrc/resid_sweep.cu) stays as the yardstick.
//
// What bounds it on this card: bytes at large batches, a latency chain at
// the served ones. Per lane-step 2·NP·(NP + 4)·4 + NP·4 bytes of tables
// (9.3 KB at NP 32), NP³ FMAs of the trilinear term, three NP² dots and
// the LU (~12k at NP 32); at B=512 the step is the chain of the T0
// segment's chunk barriers and the LU's panels over 4 lanes a block.
//
// Layout: MN, KL (nt, B, NP, NP + 4) and fN (nt, B, NP), lane-major with
// the body's row padding, so a block's step tile is one bulk copy per
// table (the wrappers in ops/resid_sweep.py convert the reference's
// (nt, NP, NP, B) layout; the engines hand these tables down directly).
// The lanes a block (4, 8 or 16; at most 8 at NP 40 and 4 above) are
// chosen by the wrapper from the batch, so that B=512 gives 128 blocks.
//
// Instantiations: NP 8..64 (the served kernels) and CLOCKED at NP 32 and
// 48 (the fleet's two padded widths). Its own translation unit, so that
// it builds in parallel with the other serving-body sources.

#include "serving_body.cuh"

namespace {

cudaError_t launch(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 8: return launch_mat_np<8, false, false>(p, s);
    case 16: return launch_mat_np<16, false, false>(p, s);
    case 24: return launch_mat_np<24, false, false>(p, s);
    case 32: return launch_mat_np<32, false, false>(p, s);
    case 40: return launch_mat_np<40, false, false>(p, s);
    case 48: return launch_mat_np<48, false, false>(p, s);
    case 56: return launch_mat_np<56, false, false>(p, s);
    case 64: return launch_mat_np<64, false, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_clocked(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 32: return launch_mat_np<32, true, false>(p, s);
    case 48: return launch_mat_np<48, true, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K2 on the serving body on `stream`; returns the cudaError_t of
// the launch (0 = ok). MN, KL (nt, B, NP, NP + 4) and fN (nt, B, NP)
// lane-major, g (nt, PROBE_P, B), T0 the fold (1, NP, NP, NP + 4) and VE
// (1, PROBE_P, NP + 4) with their rows padded, b0 (1, B), the dd carry
// state0 (4, NP, B) in and state out; `tl` lanes a block. `clk` (int64,
// grid × (PHASES + 1)) non-null launches the CLOCKED instantiation (NP 32
// and 48 only).
int romtime_resid_tables_serving(const float* MN, const float* KL,
                                 const float* fN, const float* g,
                                 const float* T0, const float* VE,
                                 const float* b0, const float* state0,
                                 float* probes, float* state, long long* clk,
                                 int nt, int NP, int B, int tl, int step0,
                                 int with_tri, int bdf2, float dt,
                                 void* stream) {
  if (NP % 8 != 0 || NP < 8 || NP > 64 || B < 1 || nt < 1 || step0 < 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.TH = g; p.Bmk = T0; p.VE = VE; p.b0 = b0; p.state0 = state0;
  p.probes = probes; p.state = state; p.clk = clk;
  p.MN = MN; p.KL = KL; p.fN = fN; p.tl = tl;
  p.W = 1; p.width = nt; p.period = nt; p.B = B;
  p.with_tri = with_tri; p.bdf2 = bdf2; p.step0 = step0; p.boundary = 0;
  p.dt = dt;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(clk ? launch_clocked(p, NP, s) : launch(p, NP, s));
}

// The launch shape for NP and `tl` lanes a block: out = (lanes a block,
// threads a block, T0 slices a chunk, shared bytes, table ring units, the
// largest lanes a block at NP); returns 0, or cudaErrorInvalidValue for a
// shape it does not take.
int romtime_resid_tables_serving_tile(int NP, int tl, int with_tri,
                                      int* out) {
  return mat_tile_for(NP, tl, with_tri, out);
}

const char* romtime_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
