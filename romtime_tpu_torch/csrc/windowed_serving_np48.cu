// K1's serving design and K3 on the serving body at NP 40 and 48 (CLOCKED
// at 48, the fleet's wider padded width), split out of
// csrc/windowed_serving.cu so that the instantiations build in parallel;
// the design and what it replaces are described there.

#include "serving_body.cuh"

namespace {

cudaError_t launch(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 40: return launch_np<40, false, false>(p, s);
    case 48: return launch_np<48, false, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_clocked(const Params& p, int NP, cudaStream_t s) {
  switch (NP) {
    case 48: return launch_np<48, true, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#include "windowed_serving_entries.cuh"
