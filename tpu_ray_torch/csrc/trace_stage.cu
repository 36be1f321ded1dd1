// Stage markers: one empty kernel a stage of the render path, launched
// <<<1, 1>>> on the current stream where a stage begins
// (utils/metrics.stage). Captured into a CUDA graph, a marker replays with
// the graph at no host cost, so a profiler's device trace names the stage
// of every kernel and copy that follows it, up to the next marker
// (benchmark/metrics/, tools.stage_ms). Each kernel's name is
// "trace_stage_" and its stage's name in utils.metrics.STAGES, a dot made an
// underscore, in the same order: `tr_trace_stage(i, ...)` launches stage i.
#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" __global__ void trace_stage_march() {}
extern "C" __global__ void trace_stage_rays() {}
extern "C" __global__ void trace_stage_walk() {}
extern "C" __global__ void trace_stage_reconstruct() {}
extern "C" __global__ void trace_stage_shadow() {}
extern "C" __global__ void trace_stage_shade() {}
extern "C" __global__ void trace_stage_vjp_forward() {}
extern "C" __global__ void trace_stage_vjp_backward() {}
extern "C" __global__ void trace_stage_vjp_accumulate() {}

extern "C" int tr_trace_stage(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: trace_stage_march<<<1, 1, 0, s>>>(); break;
    case 1: trace_stage_rays<<<1, 1, 0, s>>>(); break;
    case 2: trace_stage_walk<<<1, 1, 0, s>>>(); break;
    case 3: trace_stage_reconstruct<<<1, 1, 0, s>>>(); break;
    case 4: trace_stage_shadow<<<1, 1, 0, s>>>(); break;
    case 5: trace_stage_shade<<<1, 1, 0, s>>>(); break;
    case 6: trace_stage_vjp_forward<<<1, 1, 0, s>>>(); break;
    case 7: trace_stage_vjp_backward<<<1, 1, 0, s>>>(); break;
    case 8: trace_stage_vjp_accumulate<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
