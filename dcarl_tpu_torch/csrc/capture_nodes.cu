// Device-activity nodes of the graph a stream is capturing into: the
// phase tables of utils/profiling.py.
//
// Replaces no TPU kernel (JAX's profiler names a jitted program's parts
// from its own HLO); added so that a phase of a captured tick can be
// found in a replay's device events.  It launches nothing.
//
// While utils/graphs.TickRunner captures a tick, entering and leaving a
// phase asks how many kernel, memcpy and memset nodes the capturing graph
// holds: those are the nodes a replay reports as device events (kernel,
// memcpy, memset activities), and a tick captured on one stream is a chain
// of them, so their count at a phase's edges is the phase's first and end
// index among a replay's device events in start order.  Written against
// the runtime's headers, not as ctypes prototypes: the signature of
// cudaStreamGetCaptureInfo differs between CUDA versions, and its
// defaulted arguments take up the difference.

#include <cuda_runtime.h>

#include <vector>

// C entry point: writes to the host ``nodes`` the number of kernel, memcpy
// and memset nodes of the graph ``stream`` is capturing into, 0 when it is
// not capturing; returns a cudaError_t as an int (0 = done).
extern "C" int capture_nodes(void* stream, unsigned long long* nodes)
{
    cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
    unsigned long long id = 0;
    cudaGraph_t graph = nullptr;
    cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status,
                                               &id, &graph);
    if (err != cudaSuccess) return (int)err;
    *nodes = 0;
    if (status != cudaStreamCaptureStatusActive || graph == nullptr) return 0;
    size_t n = 0;
    err = cudaGraphGetNodes(graph, nullptr, &n);
    if (err != cudaSuccess) return (int)err;
    std::vector<cudaGraphNode_t> all(n);
    if (n > 0) {
        err = cudaGraphGetNodes(graph, all.data(), &n);
        if (err != cudaSuccess) return (int)err;
    }
    unsigned long long count = 0;
    for (size_t i = 0; i < n; ++i) {
        cudaGraphNodeType type;
        err = cudaGraphNodeGetType(all[i], &type);
        if (err != cudaSuccess) return (int)err;
        count += type == cudaGraphNodeTypeKernel
            || type == cudaGraphNodeTypeMemcpy
            || type == cudaGraphNodeTypeMemset;
    }
    *nodes = count;
    return 0;
}
