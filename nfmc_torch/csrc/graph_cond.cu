// CUDA graph conditional nodes (IF and WHILE) for a stream capture in
// progress: the device-side predicates of nfmc_torch.core.graphs.when and
// graphs.loop, the counterparts of the JAX package's lax.cond and
// lax.while_loop (NUTS's doublings and leaves, ChEES's leapfrogs).
//
// No TPU kernel is ported here. PyTorch 2.11 captures no conditional node
// from Python (torch.cuda.CUDAGraph has no begin_capture_to_if_node), so
// core/graphs.py makes one through these calls, on the streams PyTorch
// captures:
//
//   nfmc_cond_begin(parent, pred, child, loop, handle_out): on the graph
//     that `parent` is capturing, a one-thread kernel sets a new
//     conditional handle to the bool at `pred` (a device address), or to 1
//     where `pred` is null; an IF node (`loop` 0) or a WHILE node (`loop`
//     1) on that handle follows it, and `parent`'s capture goes on after
//     the node. `child`, a stream that captures nothing, starts capturing
//     into the node's body graph. An IF body runs on a replay where the
//     handle holds when the replay reaches the node; a WHILE body runs
//     while it holds, tested before each run.
//   nfmc_cond_end(child, handle, pred): where `pred` is not null, a
//     one-thread kernel at the end of the body sets the handle to the bool
//     at `pred` (a WHILE body's test for its next run); then `child`'s
//     capture of the body ends.
//   nfmc_cond_warm(): loads the condition kernel's module, outside a
//     capture (a lazily loaded module would load in the middle of one).
//   nfmc_cond_stream(): a new non-blocking stream for the bodies, or null.
//     It is never destroyed; PyTorch's own streams come from a pool that
//     hands the same streams out again, so one of them could be the stream
//     a graph itself captures on.
//   nfmc_cond_status(stream): the stream's cudaStreamCaptureStatus (0 none,
//     1 active, 2 invalidated), or -1 - the cudaError_t of the query.
//
// Nested nodes nest: a body's stream is the parent of the next. Each call
// returns 0 on success, else the cudaError_t of the call that failed plus
// 10000 times that call's place in the sequence (1 for the first), and
// synchronises nothing.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, (pred == nullptr || *pred) ? 1u : 0u);
}

}  // namespace

extern "C" int nfmc_cond_begin(void* parent, const void* pred, void* child, int loop,
                               unsigned long long* handle_out) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStream_t cs = static_cast<cudaStream_t>(child);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return 10000 + (int)err;
  if (status != cudaStreamCaptureStatusActive) return 10000 + (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return 20000 + (int)err;
  set_condition<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return 30000 + (int)err;
  err = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return 40000 + (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return 50000 + (int)err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return 60000 + (int)err;
  err = cudaStreamBeginCaptureToGraph(cs, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return 70000 + (int)err;
  *handle_out = (unsigned long long)handle;
  return 0;
}

extern "C" int nfmc_cond_end(void* child, unsigned long long handle, const void* pred) {
  cudaStream_t cs = static_cast<cudaStream_t>(child);
  if (pred != nullptr) {
    set_condition<<<1, 1, 0, cs>>>((cudaGraphConditionalHandle)handle,
                                   static_cast<const bool*>(pred));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return 10000 + (int)err;
  }
  cudaGraph_t body = nullptr;
  const cudaError_t err = cudaStreamEndCapture(cs, &body);
  return err == cudaSuccess ? 0 : 20000 + (int)err;
}

extern "C" int nfmc_cond_warm() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, set_condition);
}

extern "C" int nfmc_cond_status(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  const cudaError_t err = cudaStreamIsCapturing(static_cast<cudaStream_t>(stream), &status);
  return err == cudaSuccess ? (int)status : -1 - (int)err;
}

extern "C" void* nfmc_cond_stream() {
  cudaStream_t stream = nullptr;
  return cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) == cudaSuccess ? stream
                                                                                  : nullptr;
}
