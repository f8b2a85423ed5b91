// Phase marks of the train step (training/phases.py): one empty kernel a
// phase, launched <<<1, 1>>> on the caller's stream where the phase
// begins.  Captured into a CUDA graph, a mark is a node of the graph and
// runs at every replay, so a profiler trace shows, on the device's clock,
// where each phase of every replayed step starts.  The kernels do no
// work; each has its own name (extern "C": the trace shows it as written)
// so that a reader of the trace can tell the phases apart.
//
// Built as a library of its own (kernels/build.py MARK_SOURCES), outside
// the hash of the optimizer's kernel libraries.
#include <cuda_runtime.h>

extern "C" __global__ void repro_mark_forward_kernel() {}
extern "C" __global__ void repro_mark_backward_kernel() {}
extern "C" __global__ void repro_mark_second_order_kernel() {}
extern "C" __global__ void repro_mark_first_order_kernel() {}
extern "C" __global__ void repro_mark_apply_kernel() {}
extern "C" __global__ void repro_mark_end_kernel() {}

// Launch phase ``phase``'s mark (its index in training/phases.py PHASES)
// on ``stream``; returns the launch's CUDA error (cudaErrorInvalidValue
// for an index out of range).
extern "C" int repro_mark(int phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: repro_mark_forward_kernel<<<1, 1, 0, s>>>(); break;
    case 1: repro_mark_backward_kernel<<<1, 1, 0, s>>>(); break;
    case 2: repro_mark_second_order_kernel<<<1, 1, 0, s>>>(); break;
    case 3: repro_mark_first_order_kernel<<<1, 1, 0, s>>>(); break;
    case 4: repro_mark_apply_kernel<<<1, 1, 0, s>>>(); break;
    case 5: repro_mark_end_kernel<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
