// CUDA graph programs (anyref_tpu_torch/utils/graphs.py): one CUDA graph
// with a loop as a WHILE conditional node, the port's counterpart of a
// jax.jit whose loop stays on the device. The Predictor's request program
// (eval/runner.py) loops decoder passes as the reference's lax.while_loop
// (anyref_tpu/eval/runner.py _fn, anyref_tpu/models/anyref.py generate and
// _speculative_decode); the Trainer's step (train/trainer.py) loops its
// micro-steps as the reference's lax.scan (anyref_tpu/train/step.py).
//
// It ports no Pallas kernel. PyTorch captures three graphs into one memory
// pool (the program up to the loop, one loop body, the program after it);
// anyref_graph_program stitches them into
//
//     prefix -> condition -> WHILE { body -> condition } -> suffix
//
// each captured graph a child-graph node, and instantiates it. The
// condition kernel reads the loop's carry on the device (the position i,
// int32, and the rows' done flags, bool, where there are any) and sets the
// node's condition to i < mnt && !all(done), as the reference's cond(); a
// carry without flags (n = 0, the micro-step loop) runs mnt passes. So the
// host never reads the carry and one launch runs the whole program. It is
// one warp of one block, bound by its launch (a few bytes read): it runs
// once before the loop and once after each pass, and adds one to its
// launch counter (ops/flash.py launch_counts, "loop_condition") each time.
//
// WHILE nodes need CUDA 12.3 or later, in the runtime and in the kernel module.
#include "common.cuh"

__global__ void anyref_loop_condition(cudaGraphConditionalHandle handle,
                                      const int* i, const bool* done, int n,
                                      int mnt, unsigned long long* count) {
  int open = n == 0;  // no flags, or some row has not finished
  for (int r = threadIdx.x; r < n; r += blockDim.x) open |= done[r] ? 0 : 1;
  open = __any_sync(0xffffffffu, open);
  if (threadIdx.x == 0) {
    cudaGraphSetConditional(handle, (*i < mnt && open) ? 1u : 0u);
    atomicAdd(count, 1ull);
  }
}

static cudaError_t add_condition(cudaGraphNode_t* node, cudaGraph_t graph,
                                 const cudaGraphNode_t* dep,
                                 cudaGraphConditionalHandle* handle, const int** i,
                                 const bool** done, int* n, int* mnt,
                                 unsigned long long** count) {
  void* args[] = {handle, i, done, n, mnt, count};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(anyref_loop_condition);
  p.gridDim = dim3(1);
  p.blockDim = dim3(32);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep, 1, &p);
}

static cudaError_t add_while(cudaGraphNode_t* node, cudaGraph_t graph,
                             const cudaGraphNode_t* dep,
                             cudaGraphConditionalHandle handle, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaGraphAddNode(node, graph, dep, nullptr, 1, &p);
#else
  cudaError_t err = cudaGraphAddNode(node, graph, dep, 1, &p);
#endif
  if (err == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return err;
}

// prefix, body, suffix: the captured graphs (cudaGraph_t), cloned into the
// program, so the caller may destroy them; i: the carry's int32 position;
// done: its n bool flags (n = 0: none, done may be null); mnt: the loop's
// bound; count: the condition
// kernel's launch counter (int64). On success *exec_out is the instantiated
// program.
ANYREF_API int anyref_graph_program(void* prefix, void* body, void* suffix,
                                    const void* i, const void* done, int n,
                                    int mnt, void* count, void** exec_out) {
  cudaGraph_t g = nullptr, loop_body = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t pre, cond0, loop, pass, cond1, post;
  cudaGraphConditionalHandle handle;
  const int* ip = static_cast<const int*>(i);
  const bool* dp = static_cast<const bool*>(done);
  unsigned long long* cp = static_cast<unsigned long long*>(count);
  cudaError_t err = cudaGraphCreate(&g, 0);
  if (err == cudaSuccess)
    err = cudaGraphAddChildGraphNode(&pre, g, nullptr, 0, static_cast<cudaGraph_t>(prefix));
  if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&handle, g, 0, 0);
  if (err == cudaSuccess) err = add_condition(&cond0, g, &pre, &handle, &ip, &dp, &n, &mnt, &cp);
  if (err == cudaSuccess) err = add_while(&loop, g, &cond0, handle, &loop_body);
  if (err == cudaSuccess)
    err = cudaGraphAddChildGraphNode(&pass, loop_body, nullptr, 0, static_cast<cudaGraph_t>(body));
  if (err == cudaSuccess)
    err = add_condition(&cond1, loop_body, &pass, &handle, &ip, &dp, &n, &mnt, &cp);
  if (err == cudaSuccess)
    err = cudaGraphAddChildGraphNode(&post, g, &loop, 1, static_cast<cudaGraph_t>(suffix));
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, g, 0);
  if (g != nullptr) cudaGraphDestroy(g);
  if (err == cudaSuccess) *exec_out = exec;
  cudaGetLastError();  // the error is returned; leave none behind for a launch
  return static_cast<int>(err);
}

// One run of a program on `stream`.
ANYREF_API int anyref_graph_launch(void* exec, void* stream) {
  const cudaError_t err =
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

ANYREF_API int anyref_graph_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
