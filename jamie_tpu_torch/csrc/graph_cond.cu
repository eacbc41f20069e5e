// A conditional node for the trainer's captured epochs.
//
// jamie_tpu skips every epoch after the early stop with a lax.cond inside
// its scanned chunk (jamie_tpu/train/trainer.py:499-530). Its counterpart
// in a CUDA graph is an IF conditional node (CUDA 12.4 and later): the
// node's body runs only when its handle, set from device memory by a
// kernel that runs just before it, is nonzero. PyTorch's CUDAGraph cannot
// capture one itself, so cond_add() adds one to the graph that a stream is
// capturing: it launches `set_live` on that stream (live = !stopped, and the
// handle from it), adds the conditional node after it with a copy of an
// already captured graph (the epoch) as the body, and makes the node the
// stream's capture frontier, so that the work captured next follows it.
//
// graph_nodes() counts a graph's nodes and its kernel nodes, child graphs
// included.
//
// Nothing here is bound by bytes or operations: set_live is one thread
// reading one byte, once per replay of an outer graph (the epoch's start,
// each of its steps and its end: len_dataloader + 2 launches an epoch, the
// trainer's `_CapturedEpochs` parts). It ports no TPU kernel.

#include <cuda_runtime.h>

#include <vector>

__global__ void set_live(cudaGraphConditionalHandle handle,
                         const bool* stopped, bool* live) {
  const bool run = !*stopped;
  *live = run;
  cudaGraphSetConditional(handle, run ? 1u : 0u);
}

extern "C" int cond_add(void* stream, void* body, const void* stopped,
                        void* live) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, nullptr, &n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_live<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(stopped),
                           static_cast<bool*>(live));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, nullptr,
                                 &n_deps);
#else
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                 &n_deps);
#endif
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return err;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                   nullptr, 0, static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                             cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                             cudaStreamSetCaptureDependencies);
#endif
}

static cudaError_t count_nodes(cudaGraph_t graph, unsigned long long* nodes,
                               unsigned long long* kernels) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> all(n);
  err = cudaGraphGetNodes(graph, all.data(), &n);
  if (err != cudaSuccess) return err;
  for (cudaGraphNode_t node : all) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return err;
    *nodes += 1;
    if (type == cudaGraphNodeTypeKernel) *kernels += 1;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(node, &child);
      if (err != cudaSuccess) return err;
      err = count_nodes(child, nodes, kernels);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

extern "C" int graph_nodes(void* graph, unsigned long long* nodes,
                           unsigned long long* kernels) {
  *nodes = 0;
  *kernels = 0;
  return count_nodes(static_cast<cudaGraph_t>(graph), nodes, kernels);
}
