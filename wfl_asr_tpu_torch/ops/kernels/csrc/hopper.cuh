// Hopper (sm_90a) building blocks of the wgmma attention kernels
// (attention_wgmma.cu), written for this repository: tensor maps for the
// Tensor Memory Accelerator (TMA), mbarriers, TMA and bulk copies, wgmma
// matrix descriptors and products, and register reallocation between warp
// groups.
//
// Layout of every tile the TMA loads here: rows of 64 bf16 (128 bytes),
// under the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B): in each group of
// 8 rows (1024 bytes) the 16-byte chunk c of row r lies at chunk c ^ (r % 8).
// A box's inner extent is at most 128 bytes under that swizzle, so a bf16
// row of 128 columns is two boxes of 64 columns, stored one after the
// other ("column blocks"). A tile's base is 1024-byte aligned.
//
// wgmma reads such a tile through a matrix descriptor (PTX ISA, "Matrix
// Descriptor Format"): the start address, the leading and stride byte
// offsets (LBO, SBO) and the swizzle mode, 128 bytes (layout type 1).
// - K-major (the contraction runs along the 128-byte rows: Q and K in
//   S = Q·Kᵀ): SBO = 1024 bytes from one group of 8 rows to the next; LBO
//   is unused (1). The k-steps of 16 elements within a column block start
//   32 bytes apart; the next column block is the next box.
// - MN-major (the contraction runs down the rows: V in P·V, whose rows are
//   keys): SBO = 1024 bytes from one group of 8 rows (8 steps of the
//   contraction) to the next, so a k-step of 16 rows starts 2048 bytes on;
//   LBO = the bytes from one column block of 64 to the next (an N of 128).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wfl {
namespace hopper {

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library does not link libcuda itself
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map (cols, rows, mats) over `mats` row-major bf16 matrices of
// `rows` × `cols` (row pitch `ld` elements, a multiple of 8; `cols` ≤ ld),
// back to back: [B, H, T, D] as (D, T, B·H). Boxes of 64 columns × `box_rows`
// rows × 1 matrix, 128-byte swizzled. Elements past `cols` or `rows` load as
// zeros, so a ragged tile never reads another matrix's rows, and a store
// clips them. Returns false where the driver refuses the map.
inline bool make_map(CUtensorMap* map, const void* base, int cols, int rows,
                     int mats, int ld, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2,
                                 (cuuint64_t)ld * 2 * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Device: shared addresses, mbarriers, TMA and bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(saddr(bar)), "r"(count) : "memory");
}

// make initialised barriers visible to the other threads and to the async
// proxy (the TMA); then a __syncthreads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` more of transactions in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(saddr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(saddr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// more than about 2^35 cycles (tens of seconds) traps: a broken pipeline
// ends the launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// a box of a 3-D tensor map at (col, row, mat) into shared memory; the
// bytes complete on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, int mat,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col),
         "r"(row), "r"(mat), "r"(saddr(bar))
      : "memory");
}

// `bytes` (a multiple of 16, from a 16-byte aligned address) of global
// memory into shared memory; the bytes complete on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// a named barrier of `threads` threads (ids 1-15; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Register reallocation between warp groups (all four warps of a group
// execute it): a producer gives registers back, a consumer takes them.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// The descriptor of a 128-byte swizzled tile at shared address `addr`
// (LBO and SBO in bytes, see the head of this file).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
       | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
       | (uint64_t)1 << 62;
}

// Before the first wgmma of a batch: the registers and shared memory the
// batch reads are written
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed batches are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin accumulator registers at this point of the program: the compiler may
// not move their reads or writes across it (around wg_wait, and before
// wg_fence after the registers were changed).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The m16n8k16 A fragment of 16 columns (2j·8 .. 2j·8 + 15) of a warp's
// m64nN accumulator rows: the accumulator of an 8-column tile n holds
// (row g, columns 8n + 2t, +1) in d[4n], d[4n + 1] and row g + 8 in
// d[4n + 2], d[4n + 3], the order of the A fragment's halves.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[N],
                                       int j) {
  a[0] = pack2(d[8 * j + 0], d[8 * j + 1]);
  a[1] = pack2(d[8 * j + 2], d[8 * j + 3]);
  a[2] = pack2(d[8 * j + 4], d[8 * j + 5]);
  a[3] = pack2(d[8 * j + 6], d[8 * j + 7]);
}

// d = A·B (scale_d 0) or d += A·B, m64n64k16: A and B from shared
// memory by descriptor, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = A·B (scale_d 0) or d += A·B, m64n64k16: A from registers (each
// warp's 16 rows as the m16n8k16 A fragment), B from shared memory by
// descriptor, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// d = A·B (scale_d 0) or d += A·B, m64n128k16: A and B from shared
// memory by descriptor, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = A·B (scale_d 0) or d += A·B, m64n128k16: A from registers (each
// warp's 16 rows as the m16n8k16 A fragment), B from shared memory by
// descriptor, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

}  // namespace hopper
}  // namespace wfl
