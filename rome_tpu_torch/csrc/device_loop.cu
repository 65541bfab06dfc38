// Guarded regions of a captured CUDA graph: the IF node that
// rome_tpu_torch/utils/device_loop.py puts around a loop body.
//
// Replaces the device-side control flow of the JAX package's compiled
// programs (lax.while_loop / lax.cond in rome_tpu/solvers/gauss_newton.py
// and rome_tpu/solvers/init2d.py); it is not a TPU kernel. PyTorch's own
// Python API for conditional nodes does not exist in every release the port
// meets, so the few runtime calls live here, behind a plain C interface.
//
// rome_begin_if(stream, pred, child) appends to the graph that `stream` is
// capturing:
//   1. a one-thread kernel that reads the bool at `pred` on the device and
//      sets a new conditional handle from it (cudaGraphSetConditional);
//   2. an IF conditional node on that handle, after the kernel;
// makes the IF node the stream's only capture dependency and starts
// capturing `child` (a stream that captures nothing) into the node's body
// graph. Work issued on `child` until rome_end_if(child, ...) is the body: it
// runs on every launch of the graph whose `pred` is true at that point of
// the stream, and is skipped otherwise. Bodies nest: `stream` may itself be
// capturing a body.
//
// Limits: one 1-thread kernel and one node per guarded region, which is
// what a skipped region costs. Needs CUDA 12.4 or later (conditional nodes
// in stream capture).
//
// rome_stamp(stream, begin, acc) launches a one-thread kernel on `stream`
// that reads the card's %globaltimer (nanoseconds): with `acc` null it
// stores the reading at `begin`; else it adds (reading - *begin) to acc[0]
// and 1 to acc[1]. A pair of them brackets a device phase; captured inside
// a conditional body, a skipped body stamps nothing.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, ndeps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                  : cudaErrorStreamCaptureImplicit;
}

__global__ void stamp(long long* begin, long long* acc) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (acc == nullptr) {
    *begin = now;
  } else {
    acc[0] += now - *begin;
    acc[1] += 1;
  }
}

}  // namespace

extern "C" int rome_stamp(cudaStream_t stream, long long* begin, long long* acc) {
  stamp<<<1, 1, 0, stream>>>(begin, acc);
  return cudaGetLastError();
}

extern "C" int rome_begin_if(cudaStream_t stream, const void* pred, cudaStream_t child) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(stream, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(stream, &graph, &deps, &ndeps);  // deps: the set kernel
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(child, params.conditional.phGraph_out[0], nullptr,
                                       nullptr, 0, cudaStreamCaptureModeRelaxed);
}

// Ends the body capture rome_begin_if started on `child`; adds the body's
// own nodes (a nested IF node counts one; its body counts when it ends) to
// `*nodes`.
extern "C" int rome_end_if(cudaStream_t child, unsigned long long* nodes) {
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(child, &body);
  if (err != cudaSuccess) return err;
  size_t n = 0;
  err = cudaGraphGetNodes(body, nullptr, &n);
  *nodes += n;
  return err;
}

// The top-level nodes of a captured graph.
extern "C" int rome_graph_nodes(cudaGraph_t graph, unsigned long long* nodes) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = n;
  return err;
}
