// K1's serving design and K3 on the serving body at NP 56 and 64, split
// out of csrc/windowed_serving.cu so that the instantiations build in
// parallel; the design and what it replaces are described there.

#include "serving_body.cuh"

namespace {

cudaError_t launch(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 56: return launch_np<56, false, false>(p, s);
    case 64: return launch_np<64, false, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// No CLOCKED instantiation at these NP.
cudaError_t launch_clocked(const Params&, int, cudaStream_t) {
  return cudaErrorInvalidValue;
}

}  // namespace

#include "windowed_serving_entries.cuh"
