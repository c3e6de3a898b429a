// The stop test of the batch trace's bounce loop on the card, and the
// outer CUDA graph that runs that loop: the port of the reference's
// `lax.while_loop(w_cond, w_body, ...)` (rust_raytracer_tpu/render/
// integrator.py:248-256) inside its `jax.jit(batch_fn)`
// (render/renderer.py:57-77).
//
// loop_cond_kernel is one thread.  It reads `any_alive` (a 0-d bool, the
// bounce's `alive.any()`) and the 0-d int64 bounce index `depth`, writes
// flag = any_alive && depth < max_depth, adds 1 to the bounce counter (the
// body that ran before it was entered with a live lane: the loop enters a
// body only under a true condition), and, inside a graph, sets the
// conditional WHILE node's handle to the flag, so the card itself decides
// whether the next bounce runs.  It replaces no Pallas kernel; it is not a
// traversal and moves 11 bytes.  Its plain version is the torch expression
// `alive.any() & (depth < max_depth)` (ops/loop_cond.py).
//
// rrt_loop_graph_build assembles, from three graphs captured by PyTorch
// (torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()), the graph
//
//     child(prologue) -> WHILE(handle) { child(body) -> loop_cond_kernel }
//                     -> child(epilogue)
//
// and instantiates it.  PyTorch's CUDAGraph exposes no conditional node, so
// the outer graph is built here with the runtime's graph API (CUDA 12.4 or
// later).  The handle is created with the graph, before the kernel node
// that takes it as an argument, and resets to its default at every launch
// (cudaGraphCondAssignDefault): 1 when max_depth > 0, so a batch whose
// lanes all start alive enters the loop, as w_cond's first test does.
// Each child node holds a copy of its captured graph; the tensors the
// captures address must outlive the instantiated graph (the caller keeps
// the captures).
#include <cuda_runtime.h>
#include <cstdint>

__global__ void loop_cond_kernel(const unsigned char* any_alive,
                                 const long long* depth, int max_depth,
                                 unsigned char* flag, long long* bounces,
                                 cudaGraphConditionalHandle handle,
                                 int in_graph) {
    const unsigned int go = (*any_alive != 0 && *depth < max_depth) ? 1u : 0u;
    *flag = (unsigned char)go;
    *bounces += 1;
    if (in_graph) cudaGraphSetConditional(handle, go);
}

// The kernel alone on `stream` (no graph: the condition is only written to
// `flag`), for holding it against its plain version.
extern "C" int rrt_loop_cond(const void* any_alive, const void* depth,
                             void* flag, void* bounces, int max_depth,
                             cudaStream_t stream) {
    loop_cond_kernel<<<1, 1, 0, stream>>>(
        static_cast<const unsigned char*>(any_alive),
        static_cast<const long long*>(depth), max_depth,
        static_cast<unsigned char*>(flag), static_cast<long long*>(bounces), 0, 0);
    return (int)cudaGetLastError();
}

extern "C" int rrt_loop_cond_attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, loop_cond_kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}

static cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                            const cudaGraphNode_t* deps, size_t n_deps,
                            cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
    return cudaGraphAddNode(node, graph, deps, nullptr, n_deps, params);
#else
    return cudaGraphAddNode(node, graph, deps, n_deps, params);
#endif
}

// Builds and instantiates the loop graph; writes the graph and its
// executable into graph_out / exec_out.  Returns a cudaError_t; at the
// first error nothing is kept.
extern "C" int rrt_loop_graph_build(void* prologue, void* body, void* epilogue,
                                    const void* any_alive, const void* depth,
                                    void* flag, void* bounces, int max_depth,
                                    void** graph_out, void** exec_out) {
    cudaGraph_t graph = nullptr;
    cudaGraphExec_t exec = nullptr;
    cudaError_t err = cudaGraphCreate(&graph, 0);
    if (err != cudaSuccess) return (int)err;
    cudaGraphConditionalHandle handle;
    cudaGraphNode_t pro, loop, inner, cond, epi;
    cudaGraphNodeParams p = {};
    cudaKernelNodeParams k = {};
    int in_graph = 1;
    void* args[] = {&any_alive, &depth, &max_depth, &flag, &bounces, &handle, &in_graph};
    err = cudaGraphConditionalHandleCreate(&handle, graph, max_depth > 0 ? 1u : 0u,
                                           cudaGraphCondAssignDefault);
    if (err != cudaSuccess) goto fail;
    err = cudaGraphAddChildGraphNode(&pro, graph, nullptr, 0, static_cast<cudaGraph_t>(prologue));
    if (err != cudaSuccess) goto fail;
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = handle;
    p.conditional.type = cudaGraphCondTypeWhile;
    p.conditional.size = 1;
    err = add_node(&loop, graph, &pro, 1, &p);
    if (err != cudaSuccess) goto fail;
    err = cudaGraphAddChildGraphNode(&inner, p.conditional.phGraph_out[0], nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
    if (err != cudaSuccess) goto fail;
    k.func = reinterpret_cast<void*>(loop_cond_kernel);
    k.gridDim = dim3(1);
    k.blockDim = dim3(1);
    k.sharedMemBytes = 0;
    k.kernelParams = args;
    err = cudaGraphAddKernelNode(&cond, p.conditional.phGraph_out[0], &inner, 1, &k);
    if (err != cudaSuccess) goto fail;
    err = cudaGraphAddChildGraphNode(&epi, graph, &loop, 1, static_cast<cudaGraph_t>(epilogue));
    if (err != cudaSuccess) goto fail;
    err = cudaGraphInstantiate(&exec, graph, 0);
    if (err != cudaSuccess) goto fail;
    *graph_out = graph;
    *exec_out = exec;
    return 0;
fail:
    cudaGraphDestroy(graph);
    return (int)err;
}

extern "C" int rrt_loop_graph_launch(void* exec, cudaStream_t stream) {
    return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), stream);
}

extern "C" int rrt_loop_graph_destroy(void* graph, void* exec) {
    cudaError_t err = cudaSuccess;
    if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
    if (graph) {
        const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
        if (err == cudaSuccess) err = e2;
    }
    return (int)err;
}
