// Hopper (sm_90a) building blocks shared by the port's hand-written kernels.
//
//   - mbarriers: init, arrive, arrive with an expected transaction count, and
//     a wait on a phase's parity;
//   - TMA: tensor maps encoded on the host (any element type, bf16 operand
//     tiles with 128-byte swizzle, zero fill past the tensor's edge; cached
//     by every argument, the element type included, like the launch's shared-memory
//     attribute, so a launch adds no host work once its shapes have been
//     seen), 2-D / 4-D tile loads into shared memory that
//     complete on an mbarrier, and 2-D / 4-D tile stores from shared memory;
//   - wgmma: 64-bit shared-memory descriptors for 128-byte-swizzled tiles, the
//     fence / commit / wait instructions, and m64nNk16 bf16 -> f32 products
//     with A from shared memory (SS) or from registers (RS);
//   - setmaxnreg, to move registers from a producer warpgroup to consumers;
//     named barriers, to synchronise one warpgroup;
//   - thread-block clusters: rank and size, the cluster barrier, reads of a
//     peer CTA's shared memory (distributed shared memory), and the host's
//     cluster launch and occupancy query.
//
// Layouts.  TMA with CU_TENSOR_MAP_SWIZZLE_128B writes a box whose inner
// dimension is 64 bf16 (128 bytes) as rows of 128 bytes, 16-byte chunks
// XOR-ed with (row % 8); a row wider than 64 elements is loaded as several
// boxes, "column blocks" of [rows][64].  Such a block is both wgmma operand
// forms:
//   - K-major (the contraction axis is the 64-wide one): 8-row groups
//     1024 bytes apart (SBO); a k-step of 16 moves the start address by 32
//     bytes inside the 128-byte row; the leading offset is unused.
//   - MN-major (the 64-wide axis is M or N; used with the transpose bit):
//     8-row groups along K 1024 bytes apart (SBO), the next 64 columns of M/N
//     at the next column block (LBO); a k-step of 16 moves the start address
//     by 16 rows, 2048 bytes.
// Every tile starts on 1024 bytes, so the swizzle pattern, which the hardware
// computes from address bits, is the one TMA wrote.
//
// The header includes <cuda.h> for the tensor-map types only: the encoder is
// fetched at run time through the runtime's cudaGetDriverEntryPoint, so the
// library needs no link against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <mutex>

namespace hopper {

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival, and `bytes` more to come from TMA before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so a wait on parity 1 passes at once: producers wait on
// "empty" barriers with the flipped parity, consumers on "full" ones with
// the plain one.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------------- TMA

// Coordinates are element indices, innermost dimension first.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Shared -> global tile store; OOB parts of the box are not written.  The
// shared tile must be made visible to the async proxy first
// (fence_proxy_async after the generic-proxy writes).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N committed store groups are still reading shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N committed store groups are incomplete (written).
template <int N>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiledFn>(nullptr);
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A rank-R tensor map of `dtype` elements: dims innermost first, strides
// (bytes) of dims 1..R-1, a box of `box` elements, zeros past every edge
// (0 for the integer types too).  TMA needs a 16-byte-aligned base, strides a
// multiple of 16 bytes, box dims of at most 256 and an inner box of a
// multiple of 16 bytes; with CU_TENSOR_MAP_SWIZZLE_128B the inner box is at
// most 128 bytes (64 bf16, 128 int8, 32 f32), with no swizzle the box lands
// in shared memory as dense rows.  Returns false if cuTensorMapEncodeTiled
// refuses the map.
template <int R>
inline bool make_tensor_map(CUtensorMap* map, CUtensorMapDataType dtype,
                            CUtensorMapSwizzle swizzle, const void* base,
                            const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
                            const cuuint32_t (&box)[R]) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t elem_strides[R];
  for (int i = 0; i < R; ++i) elem_strides[i] = 1;
  return fn(map, dtype, R, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// make_tensor_map through a cache.  A map is a pure function of its
// arguments, and encoding one is a driver call on the host at every launch;
// the training paths launch each kernel on a few shapes at addresses the
// caching allocator hands out again and again.  Direct-mapped, keyed by every
// argument (the data type and the swizzle too: one address may be read as
// bf16 by one kernel and as bytes by another), so a hit returns exactly the
// map that encoding would.
template <int R>
inline bool cached_tensor_map(CUtensorMap* map, CUtensorMapDataType dtype,
                              CUtensorMapSwizzle swizzle, const void* base,
                              const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
                              const cuuint32_t (&box)[R]) {
  struct Key {
    const void* base;
    int dtype, swizzle;
    cuuint64_t dims[R], strides[R - 1];
    cuuint32_t box[R];
  };
  struct Entry {
    Key key;
    CUtensorMap map;
    bool used;
  };
  constexpr int kEntries = 1024;
  static Entry cache[kEntries];
  static std::mutex mu;
  Key key;
  memset(&key, 0, sizeof key);  // padding bytes take part in the hash and the compare
  key.base = base;
  key.dtype = int(dtype);
  key.swizzle = int(swizzle);
  memcpy(key.dims, dims, sizeof dims);
  memcpy(key.strides, strides, sizeof strides);
  memcpy(key.box, box, sizeof box);
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the key's bytes
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof key; ++i) h = (h ^ bytes[i]) * 1099511628211ull;
  Entry& e = cache[h % kEntries];
  std::lock_guard<std::mutex> lock(mu);
  if (e.used && memcmp(&e.key, &key, sizeof key) == 0) {
    *map = e.map;
    return true;
  }
  if (!make_tensor_map<R>(map, dtype, swizzle, base, dims, strides, box)) return false;
  e.key = key;
  e.map = *map;
  e.used = true;
  return true;
}

// The bf16 operand tiles of wgmma: 128-byte swizzle (see the layouts above).
template <int R>
inline bool cached_tensor_map_bf16(CUtensorMap* map, const void* base,
                                   const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
                                   const cuuint32_t (&box)[R]) {
  return cached_tensor_map<R>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B,
                              base, dims, strides, box);
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device, not at every launch: `done` (one bit per device) is a static of the
// caller's launcher, one per kernel instance.
template <typename Kernel>
inline cudaError_t set_max_dynamic_smem_once(std::atomic<uint64_t>& done, Kernel kernel,
                                             int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// --------------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled operand tile in shared memory (see the
// layouts above); offsets in bytes.
__device__ __forceinline__ uint64_t make_desc_sw128(const void* tile, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
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

// The compiler does not know that an issued wgmma goes on reading and
// writing its registers until the wait: these empty statements pin an
// accumulator (or an A fragment) at a point, so that no read, write or reuse
// of those registers moves across it.
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (N / 2 f32 a thread) += A (64 x 16) * B (16 x N), bf16 in, f32 out;
// scale_d == 0 overwrites d.  SS: A by descriptor (K-major); RS: A as four
// registers of the mma.m16n8k16 A fragment per warp (warp w holds rows
// 16w..16w+15).  B by descriptor, kTransB 0: K-major, 1: N-major.
// Accumulator layout (g = lane / 4, t = lane % 4, warp w of the warpgroup):
// d[4j + 2h + e] is row 16w + g + 8h, column 8j + 2t + e.

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, %67, %68, %69, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(1), "n"(1), "n"(0), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, %99, %100, %101, %102;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(1), "n"(1), "n"(0), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, %39, %40;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(1), "n"(1),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, %70, %71, %72;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(1), "n"(1),
        "n"(kTransB));
}

// ------------------------------------------------------------------ clusters

// This CTA's rank in its cluster, and the cluster's size in CTAs.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of every CTA of the cluster arrives, then waits for all the
// others: shared-memory writes before the arrival (release) are visible to
// every read in the cluster after the wait (acquire).  Every thread of the
// CTA calls it, its warp converged (.aligned).
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Distributed shared memory: the shared::cluster address of `p`, an object
// in this CTA's shared memory, at the same offset in the CTA of rank `rank`.
__device__ __forceinline__ uint32_t map_shared_rank(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ float4 ld_shared_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// A launch of `grid` CTAs of `threads` threads in clusters of `cluster` CTAs
// along x (grid a multiple of it), its one attribute kept in `attr`.  A
// cluster above 8 CTAs needs cudaFuncAttributeNonPortableClusterSizeAllowed
// set on the kernel.
inline cudaLaunchConfig_t cluster_config(int grid, int cluster, int threads, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), int grid, int cluster, int threads,
                                  size_t smem, cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, cluster, threads, smem, stream, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
}

// How many clusters of `cluster` CTAs (of `threads` threads and `smem` bytes
// of dynamic shared memory each) the current device can run at once; 0 if
// the runtime refuses the query (its error is cleared).
template <typename Kernel>
inline int max_active_clusters(Kernel kernel, int cluster, int threads, size_t smem) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, threads, smem, nullptr, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    (void)cudaGetLastError();
    return 0;
  }
  return n;
}

// ------------------------------------------------------------------- registers

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace hopper
