// Hopper (sm_90a) building blocks of the tensor-core kernels: mbarriers,
// TMA tile loads and the host encoding of their tensor maps, register
// rebalancing between warpgroups, named barriers, shared-memory matrix
// descriptors and bf16 wgmma in both forms (A from shared memory, "SS", or
// from registers, "RS"). Written for int8_matmul.cu's prefill body and
// extended for the causal attention kernels (causal_attention.cu,
// causal_attention_bwd.cu) and the global rel-pos attention
// (relpos_global.cu: 4-D tensor maps of strided heads, RS wgmma of N = 32,
// 48 and 80), and the fused SAM layers' GEMM (gemm.cuh: SS wgmma of N =
// 256, B MN-major).
//
// Conventions of the descriptors here: every operand tile is stored as TMA
// leaves it with CU_TENSOR_MAP_SWIZZLE_128B, in rows of 64 bf16 (128
// bytes), 16-byte chunk c of row r at chunk c ^ (r & 7), 8-row groups 1024
// bytes apart, every tile 1024-byte aligned; a wider matrix is several such
// 64-column blocks one after the other. Read along its rows (the product's
// K dimension contiguous) an operand is "K-major" (sw128_desc); read across
// them (the M or N dimension contiguous, K stepping from row to row) it is
// "MN-major" (sw128_mn_desc, the transposed operand of a wgmma).
#pragma once

#include <cuda.h>
#include <string.h>

#include "common.cuh"

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// Make the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call after mbar_init, before the block-wide barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of asynchronous copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed. A phase that never
// completes (a lost arrival or copy) traps after ~2^32 cycles (about two
// seconds): the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// The barrier receives one arrival once every cp.async this thread issued
// before has landed (the arrival counts against the barrier's initial
// count: .noinc).
__device__ __forceinline__ void cp_async_mbar_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// 2-D tile of `map` at element coordinates (c0 innermost, c1) into shared
// memory; its bytes complete the transaction count of `bar`. Out-of-bounds
// elements are zero-filled and counted.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 3-D tile of `map` at element coordinates (c0 innermost, c1, c2), as
// tma_load_2d.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 4-D tile of `map` at element coordinates (c0 innermost, c1, c2, c3), as
// tma_load_2d.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (the library is not linked against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A tensor of `rank` (2 to 4) dimensions, dims[0] innermost and contiguous,
// strides[i] the bytes between neighbours of dimension i + 1 (multiples of
// 16, in any order: a permuted view keeps its strides), read in boxes of
// box[] elements; out-of-bounds elements read 0.
static inline bool make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                   const void* p, const cuuint64_t* dims,
                                   const cuuint64_t* strides, const cuuint32_t* box,
                                   CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn f = encode_tiled();
  if (!f) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  memset(map, 0, sizeof(*map));
  return f(map, type, rank, const_cast<void*>(p), dims, strides, box, elem,
           CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A batch of `mats` bf16 matrices [rows, cols], contiguous one after the
// other (split attention heads [B * nh, L, hd]; cols a multiple of 8), read
// in 128-byte-swizzled boxes of box_rows x 64 columns of one matrix: rows
// past `rows` and columns past `cols` read 0, never the next matrix.
static inline bool bf16_batch_map(CUtensorMap* map, const void* p, int mats, int rows, int cols,
                                  int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// warpgroups
// ---------------------------------------------------------------------------
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barriers 1..15 over `threads` threads (a multiple of 32): sync
// waits until `threads` threads have arrived or synced at `id`; arrive
// counts the warp in and goes on. Two warpgroups take turns with them,
// each syncing on its own barrier, at which the other arrives.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Descriptor of a K-major, 128-byte-swizzled operand at `p` (see the top of
// this file): start address >> 4, leading offset 1 (unused by this
// layout), stride 1024 >> 4 between 8-row groups, layout 1 = 128B swizzle.
// Each k16 step inside the 64-wide row adds 32 bytes to the start.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Descriptor of an MN-major, 128-byte-swizzled operand at `p` (the
// transposed B of a wgmma with trans-b = 1): each K index is one 128-byte
// row of 64 M (or N) values, 8 K rows make one 1024-byte swizzle atom.
// Leading offset: the bytes from one 64-wide M/N block to the next
// (`mn_block_bytes`, the tile's row count x 128); stride 1024 >> 4 between
// 8-row K groups. Each k16 step adds 16 rows, 2048 bytes, to the start.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p, uint32_t mn_block_bytes) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((mn_block_bytes >> 4) & 0x3FFF) << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin a register, with its value, at this point of the program. A wgmma
// reads and writes its register operands asynchronously, which the
// compiler does not know: pinning the accumulators before the first
// wgmma_fence and after the last wgmma_wait, and a descriptor just before
// its wgmma_fence, keeps the instructions that define or read them out of
// the span between a wgmma_fence and the wait that retires its wgmma
// (ptxas serialises the wgmmas otherwise, C7513).
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint64_t& r) { asm volatile("" : "+l"(r)::"memory"); }

// A descriptor moved by `bytes` (a multiple of 16) along its start
// address: the same as the descriptor of p + bytes. The base is pinned
// first, so that each k step's descriptor is computed just before its
// wgmma: otherwise the compiler computes all of them up front and holds a
// register pair for each while the accumulators need the registers.
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t bytes) {
  fence_operand(base);
  return base + (bytes >> 4);
}

// d[64 x 192] (fp32, this warpgroup's registers) += A[64 x 16] * B[16 x
// 192], bf16, A from registers (the "RS" form), B from shared memory through
// a descriptor. a[0..3] hold this thread's bf16 pairs of A as mma.sync's
// m16n8k16 A fragment within the warp's 16 rows: rows 16 (t / 32) + g and
// g + 8 (g = (t % 32) / 4), k = 2 (t % 4) and + 1 in a[0] (row g) and a[1]
// (row g + 8), k + 8 and + 9 in a[2] and a[3]. Thread t holds rows
// 16 (t / 32) + g (+ 8) and columns 8 j + 2 (t % 4) (+ 1) of d in
// d[4 j + {0, 1, 2, 3}] (row, row, row + 8, row + 8; column, column + 1,
// column, column + 1), j < 24. The registers are read asynchronously: they
// must not change before the wgmma has completed (wgmma_wait).
__device__ __forceinline__ void wgmma_m64n192k16_bf16_rs(float (&d)[96], const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// The forms of the attention kernels and the GEMM: d[64 x N] (fp32, N / 2
// registers a thread in the accumulator layout above) += A[64 x 16] *
// B[16 x N], bf16; N = 32, 64 or 256 (SS: 256 for gemm.cuh), 32, 48, 64,
// 80 or 128 (RS).
// SS: A from shared memory through descriptor da (K-major). RS: A from
// registers as in wgmma_m64n192k16_bf16_rs. scale_d = 0 overwrites d
// instead of adding. TRANS_B = 0 reads B K-major (sw128_desc), 1 MN-major
// (sw128_mn_desc).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[40], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B)
      : "memory");
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 256, "wgmma_ss: N is 32, 64 or 256");
  if constexpr (N == 32) wgmma_m64n32k16_ss<TRANS_B>(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16_ss<TRANS_B>(d, da, db, scale_d);
  else wgmma_m64n256k16_ss<TRANS_B>(d, da, db, scale_d);
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d = 1) {
  static_assert(N == 32 || N == 48 || N == 64 || N == 80 || N == 128,
                "wgmma_rs: N is 32, 48, 64, 80 or 128");
  if constexpr (N == 32) wgmma_m64n32k16_rs<TRANS_B>(d, a, db, scale_d);
  else if constexpr (N == 48) wgmma_m64n48k16_rs<TRANS_B>(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16_rs<TRANS_B>(d, a, db, scale_d);
  else if constexpr (N == 80) wgmma_m64n80k16_rs<TRANS_B>(d, a, db, scale_d);
  else wgmma_m64n128k16_rs<TRANS_B>(d, a, db, scale_d);
}

// This thread's A fragment of an RS wgmma, k16 slice kk, from a K-major,
// 128-byte-swizzled operand in shared memory (rows of 64 bf16 in blocks of
// `block_bytes`, see the top of this file) whose warpgroup rows start at
// `rows`: ldmatrix of the warp's 16 rows, lanes 0-15 at the slice's first
// 8 columns, lanes 16-31 at its last 8.
__device__ __forceinline__ void sw128_frag(uint32_t (&a)[4], const unsigned char* rows,
                                           int block_bytes, int kk) {
  const int lane = threadIdx.x & 31, r = ((threadIdx.x >> 5) & 3) * 16 + (lane & 15);
  const int c = kk * 2 + (lane >> 4);  // 16-byte chunk of 8 columns, within the 128
  const unsigned char* p =
      rows + (c >> 3) * block_bytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  ldsm_x4(a, p);
}

// The A fragments of an RS wgmma from an fp32 accumulator of the same
// warpgroup: k16 slice kk of d[64 x N] (columns 16 kk .. 16 kk + 15) is
// this thread's a[] for a product whose K dimension is d's N, rounded to
// bf16 (the accumulator and A-fragment layouts match row for row).
__device__ __forceinline__ void acc_to_frag(const float* d, int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}
