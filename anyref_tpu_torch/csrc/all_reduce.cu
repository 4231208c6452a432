// The all-reduce over a "model" group of ranks (anyref_tpu_torch/ops/flash.py
// all_reduce, parallel/collectives.py): a sum over the ranks of one group,
// each rank a process with its own CUDA context.
//
// It ports no Pallas kernel. It is the counterpart of the all-reduce over
// "model" that XLA compiles into the reference's jitted programs (the
// Predictor's run, anyref_tpu/eval/runner.py, and the Trainer's step,
// anyref_tpu/train/trainer.py and step.py): torch.distributed's collectives
// cannot be captured into a CUDA graph over gloo, and NCCL refuses two ranks
// on one card, so the port reduces with a kernel of its own, which a graph
// holds as one node and a WHILE node's body runs once a pass.
//
// Memory the ranks share. Each rank cudaMallocs one exchange area: a header
// of flags and its own call counts, then a data buffer of two halves. The
// ranks swap the areas' cudaIpcMemHandle_t over the host and open each
// other's (on one card by CUDA IPC, across cards over peer access), once,
// when the mesh is made (parallel/mesh.py make_mesh). A launch walks the
// tensor in chunks: block b of every rank owns part b of each half; for
// chunk e (its call count) it copies its slice of the input into its part of
// half e % 2, meets block b of every other rank at a barrier, and sums the M
// ranks' parts in rank order 0..M-1 in fp32 into its slice of the output.
// So every rank gets the same bits (the ranks of a compiled decode loop
// branch on all-reduced logits), and for two ranks the sum is gloo's bit for
// bit (an fp32 sum of two terms commutes). Output may alias input.
//
// One barrier a chunk. A rank writes half e % 2 again at chunk e + 2 only
// after the barrier of chunk e + 1, which every peer reaches only after it
// has read chunk e's parts; so the double buffer needs no second barrier.
// Each barrier costs a time slice where ranks share one card (below). The
// last chunk's parts are read after their writer may have returned, so an
// area is freed (anyref_exchange_destroy) only after every rank of the group
// has synchronised its card and met the others on the host
// (parallel/mesh.py Mesh.close).
//
// Synchronisation on the device only: the call count (epoch) of each block
// lives in the header and the kernel raises it, so nothing is set from the
// host per call and a captured launch replays as it is. Flags are written
// with st.release.sys into every rank's header and read with ld.acquire.sys
// from one's own, after a system fence of every thread's writes; the peers'
// parts are read through L2 (ld.cg). Block b waits only for block b of the
// other ranks, never for a block of its own rank, and the grid is at most
// kBlocks (128) blocks of 512 threads, fewer than one H100 holds resident
// even when four ranks share it. A barrier that waits longer than the
// process group's timeout (given at creation) ends the kernel with __trap(),
// so a rank that died or went another way fails its peers instead of
// hanging them.
//
// Bound: bytes. Each rank reads its input, writes its part, reads the M
// parts and writes its output: on one card M ranks move M x (3 + M) x the
// tensor's bytes through the 3.35 TB/s of one H100's HBM. Two ranks on one
// card without MPS do not run at once: the card time-slices their contexts,
// so a barrier also waits for the other context's slice.
#include <string.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kMaxRanks = 8;
constexpr int kBlocks = 128;
constexpr int kThreads = 512;
constexpr long long kMinPerBlock = 4096;  // elements: fewer per block take fewer blocks
// header: flags [block][source rank], then each block's epoch
constexpr size_t kFlagWords = size_t(kBlocks) * kMaxRanks;
constexpr size_t kHeader = size_t(1) << 16;

// device bytes of this process's exchange areas not yet destroyed
std::atomic<long long> g_held{0};

struct Peers {
  char* base[kMaxRanks];  // every rank's exchange area in this process
};

struct Exchange {
  int rank, size;
  long long bytes;  // data bytes of each rank's buffer
  unsigned long long timeout_ns;
  Peers peers;
};

__device__ __forceinline__ unsigned* flag_words(char* base) {
  return reinterpret_cast<unsigned*>(base);
}
__device__ __forceinline__ unsigned* epochs(char* base) {
  return reinterpret_cast<unsigned*>(base) + kFlagWords;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Block b of every rank has reached chunk `epoch`: thread r < size
// posts this rank's flag in rank r's header, then waits for rank r's in its
// own. The fence and the first __syncthreads make the block's writes visible
// before any flag goes out; the second orders the block's reads after every
// flag came in.
__device__ void rank_barrier(const Peers& peers, int rank, int size, int b, unsigned epoch,
                             unsigned long long timeout_ns) {
  __threadfence_system();
  __syncthreads();
  const int r = threadIdx.x;
  if (r < size) {
    const size_t slot = size_t(b) * kMaxRanks;
    store_release(flag_words(peers.base[r]) + slot + rank, epoch);
    const unsigned* mine = flag_words(peers.base[rank]) + slot + r;
    const unsigned long long t0 = global_ns();
    while (static_cast<int>(load_acquire(mine) - epoch) < 0)
      if (global_ns() - t0 > timeout_ns) __trap();
  }
  __syncthreads();
}

// fp32 and bf16 (its bits as unsigned short) to fp32 and back, rounding to
// nearest even as torch and gloo round.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ unsigned short narrow<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T>
constexpr int kPack = 16 / sizeof(T);  // elements in 16 bytes

template <typename T>
union Pack {
  uint4 u;
  T v[kPack<T>];
};

template <typename T>
__device__ void copy_in(const T* src, T* dst, long long len, bool vec) {
  long long done = 0;
  if (vec) {
    const long long nv = len / kPack<T>;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = nv * kPack<T>;
  }
  for (long long i = done + threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

// out[i] = part_0[i] + part_1[i] + ... + part_{size-1}[i], in fp32, in rank
// order; `offset`: the block's part in every rank's area.
template <typename T>
__device__ void sum_out(const Peers& peers, int size, size_t offset, T* out, long long len,
                        bool vec) {
  constexpr int n = kPack<T>;
  long long done = 0;
  if (vec) {
    const long long nv = len / n;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      Pack<T> p;
      float acc[n];
      p.u = __ldcg(reinterpret_cast<const uint4*>(peers.base[0] + offset) + i);
#pragma unroll
      for (int j = 0; j < n; ++j) acc[j] = widen(p.v[j]);
      for (int r = 1; r < size; ++r) {
        p.u = __ldcg(reinterpret_cast<const uint4*>(peers.base[r] + offset) + i);
#pragma unroll
        for (int j = 0; j < n; ++j) acc[j] += widen(p.v[j]);
      }
#pragma unroll
      for (int j = 0; j < n; ++j) p.v[j] = narrow<T>(acc[j]);
      reinterpret_cast<uint4*>(out)[i] = p.u;
    }
    done = nv * n;
  }
  for (long long i = done + threadIdx.x; i < len; i += blockDim.x) {
    float acc = widen(__ldcg(reinterpret_cast<const T*>(peers.base[0] + offset) + i));
    for (int r = 1; r < size; ++r)
      acc += widen(__ldcg(reinterpret_cast<const T*>(peers.base[r] + offset) + i));
    out[i] = narrow<T>(acc);
  }
}

// Block b takes chunks b, b + grid, ... of `seg` elements; its part of each
// half of a rank's buffer starts `cap` bytes after the previous block's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    anyref_all_reduce_kernel(Peers peers, int rank, int size, const T* in, T* out, long long n,
                             long long seg, long long cap, int vec,
                             unsigned long long timeout_ns) {
  const int b = blockIdx.x;
  char* mine = peers.base[rank];
  __shared__ unsigned s_epoch;
  if (threadIdx.x == 0) s_epoch = epochs(mine)[b];
  __syncthreads();
  unsigned epoch = s_epoch;
  for (long long start = b * seg; start < n; start += gridDim.x * seg) {
    const long long len = n - start < seg ? n - start : seg;
    ++epoch;
    const size_t offset = kHeader + (size_t(epoch & 1) * kBlocks + b) * size_t(cap);
    copy_in(in + start, reinterpret_cast<T*>(mine + offset), len, vec);
    rank_barrier(peers, rank, size, b, epoch, timeout_ns);
    sum_out(peers, size, offset, out + start, len, vec);
  }
  if (threadIdx.x == 0) epochs(mine)[b] = epoch;
}

}  // namespace

// This rank's exchange area: `bytes` of data (a multiple of 2 x 16 x 128) after
// the header, zeroed flags and epochs; *state_out the handle of the other
// entries, handle_out (64 bytes) its cudaIpcMemHandle_t for the peers.
ANYREF_API int anyref_exchange_create(int rank, int size, long long bytes, double timeout_s,
                                      void** state_out, void* handle_out) {
  if (size < 2 || size > kMaxRanks || rank < 0 || rank >= size || bytes <= 0 ||
      bytes % (2 * 16 * kBlocks) != 0 || timeout_s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = nullptr;
  cudaIpcMemHandle_t handle;
  cudaError_t err = cudaMalloc(&base, kHeader + size_t(bytes));
  if (err == cudaSuccess) err = cudaMemset(base, 0, kHeader);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&handle, base);
  if (err != cudaSuccess) {
    if (base != nullptr) cudaFree(base);
    cudaGetLastError();
    return static_cast<int>(err);
  }
  Exchange* ex = new Exchange();
  ex->rank = rank;
  ex->size = size;
  ex->bytes = bytes;
  ex->timeout_ns = static_cast<unsigned long long>(timeout_s * 1e9);
  ex->peers.base[rank] = base;
  g_held += static_cast<long long>(kHeader) + bytes;
  memcpy(handle_out, &handle, sizeof(handle));
  *state_out = ex;
  return 0;
}

// Open every other rank's area from `handles` (size x 64 bytes, in rank
// order); a peer that cannot be mapped returns CUDA's error.
ANYREF_API int anyref_exchange_open(void* state, const void* handles) {
  Exchange* ex = static_cast<Exchange*>(state);
  for (int r = 0; r < ex->size; ++r) {
    if (r == ex->rank) continue;
    cudaIpcMemHandle_t h;
    memcpy(&h, static_cast<const char*>(handles) + r * sizeof(h), sizeof(h));
    void* p = nullptr;
    const cudaError_t err = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    ex->peers.base[r] = static_cast<char*>(p);
  }
  return 0;
}

// Unmap the other ranks' areas and free this rank's (anyref_exchange_create);
// `state` is gone after the call. The caller has synchronised its card and
// met every rank of the group after its last all-reduce: until a peer's last
// launch ends, that peer may read this area.
ANYREF_API int anyref_exchange_destroy(void* state) {
  Exchange* ex = static_cast<Exchange*>(state);
  cudaError_t first = cudaSuccess;
  for (int r = 0; r < ex->size; ++r) {
    if (r == ex->rank || ex->peers.base[r] == nullptr) continue;
    const cudaError_t err = cudaIpcCloseMemHandle(ex->peers.base[r]);
    if (first == cudaSuccess) first = err;
  }
  const cudaError_t err = cudaFree(ex->peers.base[ex->rank]);
  if (first == cudaSuccess) first = err;
  g_held -= static_cast<long long>(kHeader) + ex->bytes;
  delete ex;
  cudaGetLastError();
  return static_cast<int>(first);
}

// *out: the device bytes of this process's exchange areas not yet destroyed.
ANYREF_API int anyref_exchange_held(long long* out) {
  *out = g_held.load();
  return 0;
}

// out = the sum over the group of every rank's `in` (n elements, fp32 or,
// with bf16 set, bf16), on `stream`. Every rank of the group makes the same
// calls in the same order.
ANYREF_API int anyref_all_reduce(void* state, const void* in, void* out, long long n, int bf16,
                                 void* stream) {
  const Exchange* ex = static_cast<const Exchange*>(state);
  if (n <= 0) return 0;
  const long long elem = bf16 ? 2 : 4;
  const long long cap = ex->bytes / (2 * kBlocks);  // bytes of a block's part of a half
  const long long cap_elems = (cap / elem) & ~7ll;
  long long blocks = (n + kMinPerBlock - 1) / kMinPerBlock;
  blocks = blocks < kBlocks ? blocks : kBlocks;
  long long seg = ((n + blocks - 1) / blocks + 7) & ~7ll;
  seg = seg < cap_elems ? seg : cap_elems;
  const int vec = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    anyref_all_reduce_kernel<unsigned short><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        ex->peers, ex->rank, ex->size, static_cast<const unsigned short*>(in),
        static_cast<unsigned short*>(out), n, seg, cap, vec, ex->timeout_ns);
  else
    anyref_all_reduce_kernel<float><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        ex->peers, ex->rank, ex->size, static_cast<const float*>(in), static_cast<float*>(out), n,
        seg, cap, vec, ex->timeout_ns);
  return static_cast<int>(cudaGetLastError());
}
