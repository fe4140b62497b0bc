// The phase marker of obs/spans.py: one thread that does nothing, launched
// on the caller's stream at each boundary of a phase while a profiler runs.
// The program issues its work on one stream, so the device runs the markers
// in the order the host launched them, and a reader of the device trace
// puts every other operation in the phase that the marker before it opened.
// It takes no arguments and touches no memory: its only effect is its
// entry in the trace, under the name phase_mark_kernel.
#include <cuda_runtime.h>

namespace {

__global__ void phase_mark_kernel() {}

}  // namespace

extern "C" {

// Returns a cudaError_t.
int phase_mark(void* stream) {
  phase_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* phase_mark_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
