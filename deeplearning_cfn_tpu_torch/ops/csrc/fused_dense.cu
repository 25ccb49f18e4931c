// Fused dense for Hopper (sm_90a): out = act(x @ w + b), with plain C launchers for ctypes.
//
// Replaces two Pallas TPU kernels of deeplearning_cfn_tpu/ops/pallas_fused.py:
//   - `_fused_kernel`, launched by `_fused_forward` (the `fused_dense` path):
//     x [M,K], w [K,N], b [N] of one dtype (bf16 or f32); f32 accumulation,
//     the bias upcast to f32, act in {none, relu, tanh-form gelu} in f32, the
//     result cast to x's dtype;
//   - `_quant_kernel`, launched by `fused_dense_quantized`: the same with an
//     int8 weight wq [K,N] dequantized next to the product as
//     f32(wq) * scale[N], and an f32 product: x upcast to f32, so the result
//     is what the TPU kernel computes, not a bf16 approximation of it.
// Both read row-major matrices through the row strides given (unit stride on
// the last axis) and write a contiguous out [M,N] in x's dtype.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s f32 on CUDA
// cores, 3.35 TB/s).  At BERT-base's MLP shapes (batch 32 x seq 128 tokens),
// mlp_in (M 4096, K 768, N 3072, gelu) and mlp_out (M 4096, K 3072, N 768)
// each do 2*M*N*K = 19.3 GFLOP, 0.0195 ms at the bf16 peak, and must move
// 36.2 MB (x, w and b read once, out written once), 0.0108 ms: compute-bound.
// The quantized kernel at mlp_in computes the same product on bf16 tensor
// cores (below): one bf16 pass for a bf16 x, 0.0195 ms against 33.8 MB
// (0.0101 ms); three for an f32 x, 0.0586 ms against 65.3 MB (0.0195 ms).
// Compute-bound either way.  The f32 fused dense runs six bf16 passes
// (below): at the ResNet-50 head (M 128, K 2048, N 1000) 3.1 GFLOP, 0.0032 ms,
// against 9.76 MB (0.0029 ms); at mlp_in in f32 116 GFLOP, 0.117 ms, against
// 72.3 MB (0.022 ms).  Compute-bound, narrowly at the head, where 128 x 192
// tiles number 6 on 132 SMs: there K is split across a thread-block cluster.
//
// The TPU kernel holds the whole K axis of a 256-row tile in VMEM.  A Hopper
// block cannot (a 64-row bf16 x tile at K 3072 is 384 KB against 227 KB of
// shared memory), so a block owns one output tile and loops over K in chunks
// through shared memory, into f32 accumulators.  M, N and K
// need no padding: the TPU kernel's jnp.pad copies are not carried over.
//
// The kernels, chosen by dtype, shape and alignment (never after a failure):
//   - bf16, 16-byte-aligned rows (x and w bases on 16 bytes, row strides, K
//     and N multiples of 8 elements, K > 0): the wgmma/TMA kernel.  A
//     persistent grid (at most one CTA per SM) walks 128 x BN output tiles;
//     each CTA has three warpgroups.
//       Warpgroup 0 is the producer (setmaxnreg 40): one thread issues TMA
//     loads of the x chunk [128, 64] and the w chunk [64, BN] into a ring
//     (4 or 5 stages, 128-160 KB) with "full" and "empty" mbarriers, running
//     ahead across tile boundaries.  TMA zero-fills past M, N and K, so the
//     ragged edges need no code in the loop.  K chunks of 64 bf16 are 128
//     bytes, one swizzle atom.
//       Warpgroups 1 and 2 (setmaxnreg 232) run wgmma m64nBNk16 SS: x is the
//     K-major A operand; w stays [K, N] row-major, the JAX layout, and is the
//     N-major B operand read with the transpose bit, so nothing is copied
//     transposed.  One chunk's products stay in flight while the next
//     chunk's are issued (wgmma.wait_group 1); a stage goes back to the
//     producer when the products that read it have completed, so no
//     __syncthreads stalls the loop.
//       The epilogue adds the bias (read into registers before the tile's
//     mainloop), applies the activation in f32, writes bf16 pairs into a
//     128-byte-swizzled staging tile in shared memory (conflict-free), and
//     one thread stores it with TMA, which clips past M and N (4-byte stores
//     straight from the accumulator layout would write half sectors).
//       Two modes.  Ping-pong, where there are at least two 128 x 128 tiles
//     for every SM (mlp_in: 768 tiles): each consumer warpgroup owns whole
//     128 x 128 tiles, every other tile of its CTA, and an mbarrier pair
//     hands the tensor cores from one to the other after each mainloop, so
//     one warpgroup's epilogue (the gelu's tanhf is tens of instructions an
//     element) runs under the other's products.  Cooperative 128 x 192
//     otherwise (mlp_out: N 768 gives 192 tiles of 128 x 128 on 132 SMs):
//     both warpgroups share each tile, 64 rows each; at mlp_out that is 128
//     tiles, one for each of 128 SMs, where ping-pong would run two
//     128 x 128 mainloops one after the other on 60 SMs.
//       The host side of a launch (tensor maps, the shared-memory attribute,
//     the SM count) is cached, so a launch on shapes seen before costs what
//     a plain kernel launch costs.
//   - bf16 otherwise (ragged N or K, odd strides): 128x128 output tile, 8
//     warps of 64x32 with mma.sync m16n8k16, K chunks of 32 loaded element by
//     element with bounds checks, fragments through ldmatrix (x4 for A,
//     x4.trans for B, which reads the row-major w [K,N] as the column-major
//     operand mma wants).  Rows are padded by 16 bytes so ldmatrix does not
//     conflict on banks.
//   - int8 weight, rows TMA can describe (x and wq bases on 16 bytes, x and
//     wq rows a multiple of 16 bytes apart, N a multiple of 16, K > 0): the
//     bf16 tensor cores compute the TPU kernel's f32 product, because
//       1. every int8 value (|q| <= 128) is exact in bf16, and a bf16 x times
//          bf16(q) is an exact product that wgmma adds in f32, as the TPU
//          kernel does;
//       2. the scale is a per-column factor, sum_k x (q s) = s sum_k x q, so
//          it moves to the epilogue (the two differ by f32 rounding only);
//       3. an f32 x is split into three bf16 parts, h = x's top 8 significant
//          bits, m = the top 8 of x - h, l = x - h - m (at most 8 bits left),
//          so that x = h + m + l exactly; three products against the same B
//          tile (l, m, then h) give the f32 product at a third of the bf16
//          rate, still ~5x the f32 CUDA-core peak.
//     Persistent, as the bf16 kernel, in its cooperative 128 x 192 mode: both
//     consumer warpgroups share each tile, 64 rows each.  Warpgroup 0's one
//     thread issues TMA into a landing ring (1-5 stages, as 224 KB allows) of
//     raw chunks: the x chunk [128][64] (bf16 with the 128-byte swizzle, the
//     A operand itself; f32 as dense rows) and the int8 w chunk [64][192] as
//     dense rows.  Before each chunk's products the 256 consumer threads
//     widen w to bf16 (each byte in the mantissa of an f32 magic number, a
//     subtraction, the high half) and split an f32 x into h, m, l, writing
//     exactly the 128-byte-swizzled tiles TMA writes for a bf16 w and x into
//     a two-stage ring; each thread's fence.proxy.async makes its generic
//     stores visible to wgmma, and a named barrier waits for all of them.
//     The previous chunk's products run during the conversion.  The epilogue
//     reads the tile's scale and bias (loaded before the mainloop) and
//     applies acc * scale + bias and the activation in f32; bf16 out goes
//     through the swizzled staging tile and TMA, f32 out from the accumulator
//     as float2, a quad of threads writing a full 32-byte sector (staging
//     192 f32 columns would take 48 KB a warpgroup).
//       Converting is what bounds this kernel: conversion in a producer
//     warpgroup left the tensor cores waiting (the conversion throughput of
//     one warpgroup is below their rate), and in ping-pong mode one
//     warpgroup converts a 128-column chunk alone.  Measured at mlp_in, the
//     cooperative mode is faster for both x dtypes, so the int8 launcher has
//     no ping-pong mode and no wave rule (PERF.md).
//   - f32, rows TMA can describe (x and w bases on 16 bytes, row strides
//     multiples of 4 elements, N a multiple of 4, K > 0): the f32 product on
//     the bf16 tensor cores with both operands split in three, x = xh + xm +
//     xl and w = wh + wm + wl exactly, and the six products of parts whose
//     size reaches f32's precision (l.h, h.l, m.m, m.h, h.m, h.h, smallest
//     first), each K chunk's products summed by wgmma and added into the
//     running f32 sum on the CUDA cores: six bf16 passes, ~2.5x the f32
//     CUDA-core peak.  The int8 kernel's layout, with both operands landing
//     as f32 in K chunks of 32 and both split by the consumers; w's parts
//     are written N-major, read with the transpose bit, so w stays [K, N].
//     Where 128 x 192 tiles leave half the SMs or more idle (the ResNet-50
//     head: 6 tiles), split-K: a cluster of up to 16 CTAs shares a tile,
//     each taking a run of K chunks, and the partial tiles are summed through
//     distributed shared memory in rank order, each CTA a slice of the rows
//     (deterministic; no workspace, no atomics).  Elsewhere persistent,
//     the epilogue from the accumulator.
//   - f32 otherwise, and int8 otherwise: 64x64 output tile, 256 threads of
//     4x4 outputs, K chunks of 16, on CUDA cores (no TF32).  The loader
//     converts each element to f32 on its way into shared memory; for int8
//     it multiplies by the column's scale there, so the weight crosses device
//     memory as int8.
// The mma.sync and CUDA-core epilogues stay in registers: bias (read in the
// storage dtype, added in f32), activation in f32, cast, bounds-checked store.
//
// Launch variants, written back through the launchers' last argument:
// fused_dense (enum Variant) simt, mma_sync, wgmma_tma_128x192,
// wgmma_tma_pingpong_128x128, wgmma_tma_bf16x6_128x192 and
// wgmma_tma_bf16x6_splitk_128x192 (f32); fused_dense_quantized (enum
// QuantVariant) simt, wgmma_tma_bf16x1_128x192 (bf16 x) and
// wgmma_tma_bf16x3_128x192 (f32 x).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum Act { kNone = 0, kRelu = 1, kGelu = 2 };

struct DenseParams {
  const void* x;
  const void* w;
  const void* b;
  const float* scale;  // int8 path only
  void* out;
  int M, N, K;
  long long ldx, ldw;  // row strides in elements; out is contiguous (row stride N)
  int act;
};

// jax.nn.gelu's default (approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))).
__device__ __forceinline__ float activate(float z, int act) {
  if (act == kRelu) return fmaxf(z, 0.f);
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return z * (0.5f * (1.f + tanhf(c * (z + 0.044715f * (z * z * z)))));
  }
  return z;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ------------------------------------------------------- bf16 path: wgmma and TMA

constexpr int kWM = 128, kWK = 64;
constexpr int kWsThreads = 384;     // producer warpgroup + 2 consumer warpgroups

// Cooperative: both consumer warpgroups share each 128 x BN tile, 64 rows
// each.  Ping-pong: each consumer warpgroup owns whole 128 x BN tiles, every
// other tile of its CTA, and the two take turns at the tensor cores.
template <int BN, bool kPingpong>
struct DenseCfg {
  static constexpr int kRows = kPingpong ? 128 : 64;  // tile rows a consumer warpgroup owns
  static constexpr int kStageBytes = (kWM * kWK + kWK * BN) * 2;
  static constexpr int kOutBytes = kRows * BN * 2;    // a warpgroup's output staging tile
  // The ring takes what ~208 KB leaves after the two staging tiles.
  static constexpr int kStages = (208 * 1024 - 2 * kOutBytes) / kStageBytes;
  static constexpr int kReleases = kPingpong ? 4 : 8;  // consumer warps reading each stage
};

template <int BN, bool kPingpong>
struct __align__(1024) DenseSmem {
  using Cfg = DenseCfg<BN, kPingpong>;
  __nv_bfloat16 a[Cfg::kStages][kWM * kWK];  // x chunk [128 rows][64 k], 16 KB
  __nv_bfloat16 b[Cfg::kStages][kWK * BN];   // w chunk: BN/64 column blocks of [64 k][64 n]
  __nv_bfloat16 out[2][Cfg::kRows * BN];     // per warpgroup: BN/64 blocks of [kRows][64]
  uint64_t full[Cfg::kStages], empty[Cfg::kStages];
  uint64_t turn[2];                          // ping-pong: whose mainloop is next
};

template <int BN, bool kPingpong>
constexpr size_t smem_wgmma() {
  return sizeof(DenseSmem<BN, kPingpong>) + 1024;  // + room to align the base to 1024 bytes
}

// Persistent: CTA c walks output tiles c, c + gridDim.x, ... (N fastest).
// The producer runs ahead across tile boundaries, so the ring fills with the
// next tile's chunks while the consumers run an epilogue.
template <int BN, bool kPingpong>
__global__ void __launch_bounds__(kWsThreads, 1)
    fused_dense_wgmma(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_out, const DenseParams p) {
  using namespace hopper;
  using Cfg = DenseCfg<BN, kPingpong>;
  constexpr int kStages = Cfg::kStages, kRows = Cfg::kRows, kMBlocks = kRows / 64;
  extern __shared__ uint8_t dense_smem[];
  DenseSmem<BN, kPingpong>& sm = *reinterpret_cast<DenseSmem<BN, kPingpong>*>(
      (reinterpret_cast<uintptr_t>(dense_smem) + 1023) & ~uintptr_t(1023));
  const int tiles_n = (p.N + BN - 1) / BN;
  const int num_tiles = ((p.M + kWM - 1) / kWM) * tiles_n;
  const int num_k = (p.K + kWK - 1) / kWK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], Cfg::kReleases);
    }
    mbar_init(&sm.turn[0], 4);
    mbar_init(&sm.turn[1], 4);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: chunk `it` counts across this CTA's tiles in order.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kWM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < num_k; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.full[s], Cfg::kStageBytes);
          tma_load_2d(sm.a[s], &tm_x, &sm.full[s], kt * kWK, m0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) {
            tma_load_2d(sm.b[s] + c * kWK * 64, &tm_w, &sm.full[s], n0 + c * 64, kt * kWK);
          }
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.b);
    uint8_t* staging = reinterpret_cast<uint8_t*>(sm.out[cw]);
    int local = 0;  // index of the tile among this CTA's tiles
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, ++local) {
      if (kPingpong && (local & 1) != cw) continue;
      const int m0 = (tile / tiles_n) * kWM, n0 = (tile % tiles_n) * BN;
      const int row_base = kPingpong ? 0 : 64 * cw;  // this warpgroup's first row in the tile
      // This thread's bias pairs, read before the mainloop so that their
      // latency hides behind it.
      __nv_bfloat162 bias2[BN / 8];
#pragma unroll
      for (int jt = 0; jt < BN / 8; ++jt) {
        const int col = n0 + 8 * jt + 2 * t;
        bias2[jt] = col < p.N ? __halves2bfloat162(bias[col], bias[col + 1])
                              : __floats2bfloat162_rn(0.f, 0.f);
      }
      float acc[kMBlocks][BN / 2];
#pragma unroll
      for (int mb = 0; mb < kMBlocks; ++mb)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0.f;

      // Ping-pong: wait for the other warpgroup to have issued its mainloop
      // (warpgroup 0 goes first).
      if (kPingpong) mbar_wait(&sm.turn[cw], ((local >> 1) & 1) ^ (cw == 0 ? 1 : 0));
      int it = local * num_k;
      for (int kt = 0; kt < num_k; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&sm.full[s], (it / kStages) & 1);
#pragma unroll
        for (int mb = 0; mb < kMBlocks; ++mb) fence_operand(acc[mb]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk) {
          const uint64_t db = make_desc_sw128(sm.b[s] + kk * 16 * 64, kWK * 64 * 2, 1024);
#pragma unroll
          for (int mb = 0; mb < kMBlocks; ++mb) {
            const uint64_t da =
                make_desc_sw128(sm.a[s] + (row_base + 64 * mb) * kWK + kk * 16, 16, 1024);
            wgmma_ss<1>(acc[mb], da, db, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done: hand its stage back
#pragma unroll
        for (int mb = 0; mb < kMBlocks; ++mb) fence_operand(acc[mb]);
        if (kt > 0 && lane == 0) mbar_arrive(&sm.empty[(it - 1) % kStages]);
      }
      if (kPingpong && lane == 0) mbar_arrive(&sm.turn[cw ^ 1]);
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < kMBlocks; ++mb) fence_operand(acc[mb]);
      if (num_k > 0 && lane == 0) mbar_arrive(&sm.empty[(it - 1) % kStages]);

      // Epilogue: bias and activation in f32, bf16 pairs into the staging
      // tile (128-byte-swizzled like a TMA box: conflict-free), then one
      // thread stores it with TMA, which clips rows and columns past M and N.
      if (tid == 0) tma_store_wait_read<0>();  // the previous store has read the tile
      named_barrier_sync(1 + cw, 128);
#pragma unroll
      for (int mb = 0; mb < kMBlocks; ++mb) {
#pragma unroll
        for (int jt = 0; jt < BN / 8; ++jt) {
          const float b0 = __low2float(bias2[jt]), b1 = __high2float(bias2[jt]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rr = 64 * mb + 16 * warp + g + 8 * r;  // row in the staging tile
            const float v0 = activate(acc[mb][4 * jt + 2 * r] + b0, p.act);
            const float v1 = activate(acc[mb][4 * jt + 2 * r + 1] + b1, p.act);
            *reinterpret_cast<uint32_t*>(staging + (jt / 8) * (kRows * 128) + rr * 128 +
                                         (((jt % 8) ^ g) * 16) + 4 * t) = pack_bf16(v0, v1);
          }
        }
      }
      fence_proxy_async();
      named_barrier_sync(1 + cw, 128);
      if (tid == 0 && m0 + row_base < p.M) {
#pragma unroll
        for (int cb = 0; cb < BN / 64; ++cb) {
          if (n0 + 64 * cb < p.N) {
            tma_store_2d(&tm_out, staging + cb * (kRows * 128), n0 + 64 * cb, m0 + row_base);
          }
        }
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait<0>();
  }
}

// ------------------------- int8-weight path: widened in shared memory, wgmma and TMA

// setmaxnreg.inc takes only registers that .dec gave back, so from the
// launch's 168 a thread (65,536 over 384 threads, in steps of 8) the producer
// and the two consumer warpgroups may together ask for no more than 3 x 168;
// more would block the consumers for ever.  These and the constants below
// hold for the f32 kernel too, which shares this kernel's layout.
constexpr int kQuantProducerRegs = 40, kQuantConsumerRegs = 232;
static_assert(kQuantProducerRegs + 2 * kQuantConsumerRegs <= 3 * (65536 / kWsThreads / 8 * 8),
              "setmaxnreg asks for more registers than the launch holds");

// 128 x 192 output tiles, both consumer warpgroups on each (64 rows each),
// both converting each chunk.
constexpr int kQBN = 192;
constexpr int kQConvThreads = 256;  // the two consumer warpgroups
constexpr int kQReleases = 8;       // consumer warps that use each stage

// kParts bf16 parts of x: 1 for a bf16 x, 3 (h, m, l) for an f32 x.
template <int kParts>
struct QuantCfg {
  static constexpr int kABytes = kWM * kWK * 2;  // one bf16 part of the x chunk, 16 KB
  // TMA's landing stage: the x chunk [128][64] (bf16 with the 128-byte
  // swizzle, which is wgmma's A operand as it lands; or f32 as dense rows),
  // then the int8 w chunk [64][192] as dense rows.
  static constexpr int kLandXBytes = kWM * kWK * (kParts == 1 ? 2 : 4);
  static constexpr int kLandBytes = kLandXBytes + kWK * kQBN;
  // The consumers' two-stage ring of converted operands: w widened to bf16,
  // and for an f32 x its parts h, m, l (a bf16 x keeps a 1 KB placeholder).
  static constexpr int kPartsBytes = kParts == 3 ? 3 * kABytes : 1024;
  static constexpr int kConvBytes = kWK * kQBN * 2 + kPartsBytes;
  static constexpr int kOutBytes = kParts == 1 ? 64 * kQBN * 2 : 0;  // bf16 staging tile
  // The landing ring takes what is left of 224 KB, up to six stages.
  static constexpr int kFree = 224 * 1024 - 2 * kOutBytes - 2 * kConvBytes;
  static constexpr int kLand = kFree / kLandBytes < 6 ? kFree / kLandBytes : 6;
  // A bf16 x's landing stage is held until the products that read it are
  // done, so its ring needs a stage beyond the two in use.
  static_assert(kLand >= (kParts == 1 ? 3 : 1), "too few landing stages");
};

template <int kParts>
struct __align__(1024) QuantSmem {
  using Cfg = QuantCfg<kParts>;
  uint8_t land[Cfg::kLand][Cfg::kLandBytes];
  __nv_bfloat16 b[2][kWK * kQBN];                    // w chunk, laid out as TMA lays a bf16 w
  __nv_bfloat16 a[2][Cfg::kPartsBytes / 2];          // f32 x: parts h, m, l, each [128][64]
  uint8_t out[2][Cfg::kOutBytes > 0 ? Cfg::kOutBytes : 16];
  alignas(16) float epi[2][2][kQBN];  // per consumer warpgroup: the tile's scale and bias
  uint64_t land_full[Cfg::kLand], land_empty[Cfg::kLand];
  uint64_t empty[2];  // the converted ring: its products are done
};

template <int kParts>
constexpr size_t smem_quant() {
  return sizeof(QuantSmem<kParts>) + 1024;
}

// The high halves of two f32 (their bf16 truncations) as one bf16 pair, a in
// the low half.
__device__ __forceinline__ uint32_t high_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ float truncate_bf16(float a) {
  return __uint_as_float(__float_as_uint(a) & 0xFFFF0000u);
}

// Four int8 (one 32-bit word) to four bf16, exactly: byte q + 128 becomes the
// low mantissa bits of the f32 2^23 + q + 128, less 2^23 + 128 gives q, and q
// (|q| <= 128, 8 significant bits) leaves the low 16 bits of its f32 zero, so
// its bf16 is the high half.
__device__ __forceinline__ void widen4(uint32_t q, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = high_halves(f0, f1);
  hi = high_halves(f2, f3);
}

// Two f32 values as three bf16 pairs with x = h + m + l exactly: h is x's
// top 8 significant bits (truncated), the remainder r = x - h is exact in
// f32 and holds at most the 16 bits below them, m its top 8 significant
// bits, and l = r - m the at most 8 bits left, exact in bf16.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& h, uint32_t& m, uint32_t& l) {
  const float r0 = x0 - truncate_bf16(x0), r1 = x1 - truncate_bf16(x1);
  const float m0 = truncate_bf16(r0), m1 = truncate_bf16(r1);
  h = high_halves(x0, x1);
  m = high_halves(m0, m1);
  l = high_halves(r0 - m0, r1 - m1);
}

// The int8 w chunk [64 k][BN n] (dense rows) widened into BN/64 column blocks
// of [64 k][64 n] bf16 with the 128-byte swizzle, the layout TMA gives a bf16
// w: 16 bytes in, 16 values, two swizzled 16-byte chunks out.  Eight
// neighbouring threads take four 16-byte pieces of one block in two
// neighbouring k rows, whose swizzled chunks fall on eight different bank
// groups.  A fixed count of units a thread, unrolled, so that each thread
// has several loads in flight.
template <int BN, int kConvThreads>
__device__ __forceinline__ void widen_w(const uint8_t* land, __nv_bfloat16* b, int ct) {
  constexpr int kBlocks = BN / 64, kUnits = kWK * BN / 16;
  static_assert(kUnits % kConvThreads == 0, "whole units a thread");
  uint8_t* blocks = reinterpret_cast<uint8_t*>(b);
#pragma unroll
  for (int i = 0; i < kUnits / kConvThreads; ++i) {
    const int u = ct + i * kConvThreads;
    const int piece = u % 4, blk = (u / 4 / 2) % kBlocks;
    const int k = 2 * (u / (8 * kBlocks)) + (u / 4) % 2, c = 2 * piece;
    const uint4 q = *reinterpret_cast<const uint4*>(land + k * BN + blk * 64 + piece * 16);
    uint4 w0, w1;
    widen4(q.x, w0.x, w0.y);
    widen4(q.y, w0.z, w0.w);
    widen4(q.z, w1.x, w1.y);
    widen4(q.w, w1.z, w1.w);
    uint8_t* row = blocks + blk * (kWK * 128) + k * 128;
    *reinterpret_cast<uint4*>(row + ((c ^ (k % 8)) * 16)) = w0;
    *reinterpret_cast<uint4*>(row + (((c + 1) ^ (k % 8)) * 16)) = w1;
  }
}

// The f32 x chunk [128 rows][64 k] (dense rows) split into the parts h, m, l,
// each [128][64] bf16 with the 128-byte swizzle, the layout TMA gives a bf16
// x, one after another from `parts`: 4 values in, 8 bytes out to each part.
template <int kConvThreads>
__device__ __forceinline__ void split_x(const float* land, __nv_bfloat16* parts, int ct) {
  constexpr int kUnits = kWM * kWK / 4;
  static_assert(kUnits % kConvThreads == 0, "whole units a thread");
  uint8_t* out = reinterpret_cast<uint8_t*>(parts);
#pragma unroll 4
  for (int i = 0; i < kUnits / kConvThreads; ++i) {
    const int u = ct + i * kConvThreads;
    const int r = u / 16, q = u % 16;
    const float4 v = *reinterpret_cast<const float4*>(land + r * kWK + 4 * q);
    uint2 h, m, l;
    split2(v.x, v.y, h.x, m.x, l.x);
    split2(v.z, v.w, h.y, m.y, l.y);
    const int off = r * 128 + (((q / 2) ^ (r % 8)) * 16) + (q % 2) * 8;
    *reinterpret_cast<uint2*>(out + off) = h;
    *reinterpret_cast<uint2*>(out + kWM * kWK * 2 + off) = m;
    *reinterpret_cast<uint2*>(out + 2 * kWM * kWK * 2 + off) = l;
  }
}

// The bf16 kernel's persistent layout in its cooperative 128 x 192 mode,
// with the conversion in the consumers.  The producer warpgroup's one thread
// lands raw chunks by TMA in a ring with full/empty mbarriers.  Before each
// chunk's products both consumer warpgroups convert the chunk into a
// two-stage ring of bf16 operands (its own empty mbarriers say when the
// products that read a stage are done), on warps that would otherwise wait
// for the previous chunk's products, which run meanwhile.  An f32 x's
// landing stage is free once converted; a bf16 x's, which is the A operand
// itself, once its products are done.
template <int kParts>
__global__ void __launch_bounds__(kWsThreads, 1)
    fused_dense_quant_wgmma(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_w,
                            const __grid_constant__ CUtensorMap tm_out, const DenseParams p) {
  using namespace hopper;
  using Cfg = QuantCfg<kParts>;
  constexpr int BN = kQBN, kLand = Cfg::kLand;
  extern __shared__ uint8_t quant_smem[];
  QuantSmem<kParts>& sm = *reinterpret_cast<QuantSmem<kParts>*>(
      (reinterpret_cast<uintptr_t>(quant_smem) + 1023) & ~uintptr_t(1023));
  const int tiles_n = (p.N + BN - 1) / BN;
  const int num_tiles = ((p.M + kWM - 1) / kWM) * tiles_n;
  const int num_k = (p.K + kWK - 1) / kWK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int l = 0; l < kLand; ++l) {
      mbar_init(&sm.land_full[l], 1);
      mbar_init(&sm.land_empty[l], kQReleases);
    }
    mbar_init(&sm.empty[0], kQReleases);
    mbar_init(&sm.empty[1], kQReleases);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues TMA, as far ahead as the landing ring
    // allows.  Chunk `it` counts across this CTA's tiles in order.
    setmaxnreg_dec<kQuantProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kWM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < num_k; ++kt, ++it) {
          const int l = it % kLand;
          mbar_wait(&sm.land_empty[l], ((it / kLand) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.land_full[l], Cfg::kLandBytes);
          tma_load_2d(sm.land[l], &tm_x, &sm.land_full[l], kt * kWK, m0);
          tma_load_2d(sm.land[l] + Cfg::kLandXBytes, &tm_w, &sm.land_full[l], n0, kt * kWK);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each tile.
    setmaxnreg_inc<kQuantConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int ct = threadIdx.x - 128;  // this thread's index among the converting threads
    const int row_base = 64 * cw;
    float* epi_scale = sm.epi[cw][0];
    float* epi_bias = sm.epi[cw][1];
    uint8_t* staging = sm.out[cw];
    constexpr int kCols = (BN + 127) / 128;  // columns of scale and bias a thread loads
    int it = 0;
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kWM, n0 = (tile % tiles_n) * BN;
      // The tile's scale and bias, read before the mainloop so that their
      // latency hides behind it; they reach the epilogue through shared memory.
      float col_scale[kCols], col_bias[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = tid + 128 * i, col = n0 + c;
        const bool in = c < BN && col < p.N;
        col_scale[i] = in ? p.scale[col] : 0.f;
        if constexpr (kParts == 1) {
          col_bias[i] = in ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.b)[col]) : 0.f;
        } else {
          col_bias[i] = in ? static_cast<const float*>(p.b)[col] : 0.f;
        }
      }
      // acc: the sum over the chunks done.  With an f32 x, chunk holds one K
      // chunk's products, summed by wgmma (its first product overwrites it),
      // and the CUDA cores add it into acc, rounded to nearest: wgmma's own
      // f32 additions do not round to nearest, and three products a k-step
      // added into one running sum drift over a long K.  A bf16 x has one
      // product a k-step, summed in acc as bf16 mm sums it.
      float acc[BN / 2], chunk[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      for (int kt = 0; kt < num_k; ++kt, ++it) {
        const int l = it % kLand, s = it % 2;
        mbar_wait(&sm.land_full[l], (it / kLand) & 1);
        mbar_wait(&sm.empty[s], ((it / 2) & 1) ^ 1);
        // Widen (and split) the landed chunk into the free converted stage
        // while the previous chunk's products run.
        widen_w<BN, kQConvThreads>(sm.land[l] + Cfg::kLandXBytes, sm.b[s], ct);
        if constexpr (kParts == 3) {
          split_x<kQConvThreads>(reinterpret_cast<const float*>(sm.land[l]), sm.a[s], ct);
        }
        // wgmma reads the converted stage, and TMA rewrites the landing
        // stage, through the async proxy: order this thread's generic stores
        // and loads before them, then wait for every converting thread.
        fence_proxy_async();
        named_barrier_sync(3, kQConvThreads);
        const __nv_bfloat16* a = kParts == 1 ? reinterpret_cast<const __nv_bfloat16*>(sm.land[l])
                                             : sm.a[s];
        if constexpr (kParts == 3) {
          if (lane == 0) mbar_arrive(&sm.land_empty[l]);
          // The previous chunk's products are done (their run overlapped this
          // chunk's conversion): add them into acc, and hand their stage back.
          wgmma_wait<0>();
          fence_operand(chunk);
          if (kt > 0) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] += chunk[i];
            if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % 2]);
          }
          fence_operand(chunk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWK / 16; ++kk) {
            const uint64_t db = make_desc_sw128(sm.b[s] + kk * 16 * 64, kWK * 64 * 2, 1024);
            // The small parts first: l, m, then h, against the same B tile.
#pragma unroll
            for (int part = kParts - 1; part >= 0; --part) {
              const uint64_t da =
                  make_desc_sw128(a + part * kWM * kWK + row_base * kWK + kk * 16, 16, 1024);
              wgmma_ss<1>(chunk, da, db, kk > 0 || part < kParts - 1);
            }
          }
          wgmma_commit();
        } else {
          fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWK / 16; ++kk) {
            const uint64_t db = make_desc_sw128(sm.b[s] + kk * 16 * 64, kWK * 64 * 2, 1024);
            const uint64_t da = make_desc_sw128(a + row_base * kWK + kk * 16, 16, 1024);
            wgmma_ss<1>(acc, da, db, 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous chunk's products are done: hand its stages back
          fence_operand(acc);
          if (kt > 0 && lane == 0) {
            mbar_arrive(&sm.empty[(it - 1) % 2]);
            mbar_arrive(&sm.land_empty[(it - 1) % kLand]);
          }
        }
      }
      wgmma_wait<0>();
      if constexpr (kParts == 3) {
        fence_operand(chunk);
        if (num_k > 0) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += chunk[i];
        }
      } else {
        fence_operand(acc);
      }
      if (num_k > 0 && lane == 0) {
        mbar_arrive(&sm.empty[(it - 1) % 2]);
        if (kParts == 1) mbar_arrive(&sm.land_empty[(it - 1) % kLand]);
      }

      // Epilogue: acc * scale + bias, the activation in f32, x's dtype out.
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (tid + 128 * i < BN) {
          epi_scale[tid + 128 * i] = col_scale[i];
          epi_bias[tid + 128 * i] = col_bias[i];
        }
      }
      if constexpr (kParts == 1) {
        if (tid == 0) tma_store_wait_read<0>();  // the previous store has read the staging tile
      }
      named_barrier_sync(1 + cw, 128);
      if constexpr (kParts == 1) {
        // bf16 pairs into the swizzled staging tile, stored with TMA (as the
        // bf16 kernel's epilogue).
#pragma unroll
        for (int jt = 0; jt < BN / 8; ++jt) {
          const int cl = 8 * jt + 2 * t;
          const float2 s2 = *reinterpret_cast<const float2*>(epi_scale + cl);
          const float2 b2 = *reinterpret_cast<const float2*>(epi_bias + cl);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rr = 16 * warp + g + 8 * r;
            const float v0 = activate(acc[4 * jt + 2 * r] * s2.x + b2.x, p.act);
            const float v1 = activate(acc[4 * jt + 2 * r + 1] * s2.y + b2.y, p.act);
            *reinterpret_cast<uint32_t*>(staging + (jt / 8) * (64 * 128) + rr * 128 +
                                         (((jt % 8) ^ g) * 16) + 4 * t) = pack_bf16(v0, v1);
          }
        }
        fence_proxy_async();
        named_barrier_sync(1 + cw, 128);
        if (tid == 0 && m0 + row_base < p.M) {
#pragma unroll
          for (int cb = 0; cb < BN / 64; ++cb) {
            if (n0 + 64 * cb < p.N) {
              tma_store_2d(&tm_out, staging + cb * (64 * 128), n0 + 64 * cb, m0 + row_base);
            }
          }
          tma_store_commit();
        }
      } else {
        // f32 pairs straight from the accumulator: a quad of threads writes
        // 32 contiguous bytes of a row, a full sector.  N is a multiple of 16,
        // so a pair is in or out whole.
        float* out = static_cast<float*>(p.out);
#pragma unroll
        for (int jt = 0; jt < BN / 8; ++jt) {
          const int cl = 8 * jt + 2 * t, col = n0 + cl;
          const float2 s2 = *reinterpret_cast<const float2*>(epi_scale + cl);
          const float2 b2 = *reinterpret_cast<const float2*>(epi_bias + cl);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = m0 + row_base + 16 * warp + g + 8 * r;
            if (row < p.M && col < p.N) {
              const float2 v = make_float2(activate(acc[4 * jt + 2 * r] * s2.x + b2.x, p.act),
                                           activate(acc[4 * jt + 2 * r + 1] * s2.y + b2.y, p.act));
              *reinterpret_cast<float2*>(out + (long long)row * p.N + col) = v;
            }
          }
        }
        named_barrier_sync(1 + cw, 128);  // scale and bias read before the next tile writes them
      }
    }
    if constexpr (kParts == 1) {
      if (tid == 0) tma_store_wait<0>();
    }
  }
}

// ------------------------------ f32 path: both operands split in three, wgmma and TMA

// K chunks of 32 f32 (one 128-byte row of x): with both operands landing as
// f32 and converted into three bf16 parts each, a 64-deep chunk would leave
// room for one converted stage only, and the products would wait for every
// conversion.  At 32 there are two, as in the int8 kernel.
constexpr int kFK = 32;
constexpr int kF32BN = kQBN;      // 128 x 192 tiles, as the int8 kernel; split-K: one a cluster
constexpr int kMaxSplits = 16;    // CTAs a cluster (above 8: non-portable)
constexpr int kMinSplitChunks = 2;

struct F32Cfg {
  static constexpr int BN = kF32BN;
  // TMA's landing stage: the x chunk [128][32] and the w chunk [32][BN], f32 dense rows.
  static constexpr int kLandXBytes = kWM * kFK * 4;
  static constexpr int kLandBytes = kLandXBytes + kFK * BN * 4;
  // x's parts in two [128][64] bf16 tiles with the 128-byte swizzle: h in k
  // 0..31 and m in k 32..63 of the first, l in k 0..31 of the second, so that
  // each part is read by the descriptors of a 64-wide tile's k-steps.
  static constexpr int kABytes = 2 * kWM * 64 * 2;
  static constexpr int kBPartBytes = kFK * BN * 2;  // one part of w: BN/64 blocks of [32][64]
  static constexpr int kConvBytes = kABytes + 3 * kBPartBytes;
  // The landing ring takes what is left of 224 KB after two converted stages, up to four.
  static constexpr int kFree = 224 * 1024 - 2 * kConvBytes;
  static constexpr int kLand = kFree / kLandBytes < 4 ? kFree / kLandBytes : 4;
  static_assert(kLand >= 2, "too few landing stages");
  // Split-K: the CTA's partial tile, f32 rows padded by 8 floats (float2
  // stores from the accumulator layout without bank conflicts), written over
  // the landing ring and x's converted parts once the mainloop is done.
  static constexpr int kPartLd = BN + 8;
  static_assert(kWM * kPartLd * 4 <= kLand * kLandBytes + 2 * kABytes, "partial tile over the rings");
};

struct __align__(1024) F32Smem {
  using Cfg = F32Cfg;
  uint8_t land[Cfg::kLand][Cfg::kLandBytes];        // split-K, then: the partial tile over land and a
  __nv_bfloat16 a[2][Cfg::kABytes / 2];             // x's parts h|m and l
  __nv_bfloat16 b[2][3][Cfg::kBPartBytes / 2];      // w's parts h, m, l, laid out as TMA lays a bf16 w
  alignas(16) float bias[2][kF32BN];                    // no split: per consumer warpgroup, the tile's bias
  uint64_t land_full[Cfg::kLand], land_empty[Cfg::kLand];
  uint64_t empty[2];  // the converted ring: its products are done
};

constexpr size_t smem_f32() {
  return sizeof(F32Smem) + 1024;
}

// The f32 x chunk [128 rows][32 k] (dense rows) split into h, m, l in the
// two swizzled tiles of F32Cfg: 4 values in, 8 bytes out to each part.  A
// warp takes rows r, r + 1, r + 4, r + 5, whose swizzled halves of a row fall
// on all 32 banks.
template <int kConvThreads>
__device__ __forceinline__ void split_x32(const float* land, __nv_bfloat16* a, int ct) {
  constexpr int kUnits = kWM * kFK / 4;
  static_assert(kUnits % kConvThreads == 0, "whole units a thread");
  uint8_t* out = reinterpret_cast<uint8_t*>(a);
#pragma unroll
  for (int i = 0; i < kUnits / kConvThreads; ++i) {
    const int u = ct + i * kConvThreads;
    const int q = u % 8;  // k 4q .. 4q + 3
    const int r = (u / 64) * 8 + ((u / 32) % 2) * 2 + ((u / 16) % 2) * 4 + (u / 8) % 2;
    const float4 v = *reinterpret_cast<const float4*>(land + r * kFK + 4 * q);
    uint2 h, m, l;
    split2(v.x, v.y, h.x, m.x, l.x);
    split2(v.z, v.w, h.y, m.y, l.y);
    const int row = r * 128, half = (q % 2) * 8;
    *reinterpret_cast<uint2*>(out + row + (((q / 2) ^ (r % 8)) * 16) + half) = h;
    *reinterpret_cast<uint2*>(out + row + (((4 + q / 2) ^ (r % 8)) * 16) + half) = m;
    *reinterpret_cast<uint2*>(out + kWM * 128 + row + (((q / 2) ^ (r % 8)) * 16) + half) = l;
  }
}

// The f32 w chunk [32 k][BN n] (dense rows) split into h, m, l, one after
// another from `parts`, each BN/64 column blocks of [32 k][64 n] bf16 with
// the 128-byte swizzle: the layout TMA gives a bf16 w, read N-major with the
// transpose bit.  4 values in, 8 bytes out to each part; sixteen neighbouring
// threads read 256 contiguous bytes and fill one 128-byte row of a block.
template <int kConvThreads>
__device__ __forceinline__ void split_w32(const float* land, __nv_bfloat16* parts, int ct) {
  constexpr int BN = kF32BN;
  constexpr int kUnits = kFK * BN / 4, kPartBytes = kFK * BN * 2;
  static_assert(kUnits % kConvThreads == 0, "whole units a thread");
  uint8_t* out = reinterpret_cast<uint8_t*>(parts);
#pragma unroll
  for (int i = 0; i < kUnits / kConvThreads; ++i) {
    const int u = ct + i * kConvThreads;
    const int q = u % 16, k = (u / 16) % kFK, blk = u / (16 * kFK);  // n = 64 blk + 4q
    const float4 v = *reinterpret_cast<const float4*>(land + k * BN + blk * 64 + 4 * q);
    uint2 h, m, l;
    split2(v.x, v.y, h.x, m.x, l.x);
    split2(v.z, v.w, h.y, m.y, l.y);
    const int off = blk * (kFK * 128) + k * 128 + (((q / 2) ^ (k % 8)) * 16) + (q % 2) * 8;
    *reinterpret_cast<uint2*>(out + off) = h;
    *reinterpret_cast<uint2*>(out + kPartBytes + off) = m;
    *reinterpret_cast<uint2*>(out + 2 * kPartBytes + off) = l;
  }
}

// Split-K: CTA `rank` of a cluster of kSplits sums rows [rank R, rank R + R)
// (R = 128 / kSplits) of the tile over every CTA's partial tile, through
// distributed shared memory, in rank order (the same bits whatever the
// timing), then adds the bias, applies the activation and stores float4s.
// The peer count is a template argument so that the loads stay in registers.
template <int kSplits>
__device__ __forceinline__ void reduce_partials(const float* part, uint32_t rank, int m0, int n0,
                                                const DenseParams& p, int ct) {
  constexpr int BN = kF32BN, kPartLd = F32Cfg::kPartLd;
  constexpr int kRows = kWM / kSplits, kUnits = kRows * BN / 4;
  const float* bias = static_cast<const float*>(p.b);
  float* out = static_cast<float*>(p.out);
  for (int u = ct; u < kUnits; u += kQConvThreads) {
    const int row = int(rank) * kRows + u / (BN / 4), c = 4 * (u % (BN / 4));
    const int grow = m0 + row, col = n0 + c;
    if (grow >= p.M || col >= p.N) continue;  // N is a multiple of 4: a float4 is in or out whole
    const float* src = part + row * kPartLd + c;
    float4 v[kSplits];  // every peer's load in flight at once
#pragma unroll
    for (int q = 0; q < kSplits; ++q) v[q] = hopper::ld_shared_cluster_f4(hopper::map_shared_rank(src, q));
    float4 sum = v[0];
#pragma unroll
    for (int q = 1; q < kSplits; ++q) {
      sum.x += v[q].x;
      sum.y += v[q].y;
      sum.z += v[q].z;
      sum.w += v[q].w;
    }
    *reinterpret_cast<float4*>(out + (long long)grow * p.N + col) =
        make_float4(activate(sum.x + bias[col], p.act), activate(sum.y + bias[col + 1], p.act),
                    activate(sum.z + bias[col + 2], p.act), activate(sum.w + bias[col + 3], p.act));
  }
}

// act(x @ w + b) for f32 x, w and b on the bf16 tensor cores.  x = xh + xm
// + xl and w = wh + wm + wl exactly (split2), and the products of the parts
// whose size reaches f32's precision run, smallest first (x part . w part):
// l.h, h.l, m.m, m.h, h.m, h.h.  Each is exact in f32 (8 x 8 significant
// bits).  Of the three left out, m.l and l.m are below 2^-24 |x| |w| and l.l
// below 2^-32 |x| |w|, a term.
//   The twelve products of a K chunk (two k-steps of six) sum into a chunk
// accumulator, which the CUDA cores then add into the running sum.  wgmma's
// f32 accumulation does not round to nearest: summing every product into the
// running sum would cut each of its K/16 x 6 sums toward zero, an error that
// grows with K (5.7x f32 addmm's at K 768, against a float64 reference).  So
// the running sum takes one rounded addition a chunk, as an f32 sum does.
//
// The int8 kernel's layout: warpgroup 0's one thread lands raw f32 chunks
// by TMA (zero fill past M, N and K); both consumer warpgroups split each
// chunk into a two-stage ring of bf16 parts while the previous chunk's
// products run, then run that chunk's products, 64 tile rows each.
//   No split (kSplit false): persistent, CTA c walks the 128 x BN tiles c,
// c + gridDim.x, ..., every K chunk of each; the epilogue adds the bias and
// applies the activation in f32 and stores f32 pairs from the accumulator.
//   Split-K (kSplit true): a cluster of `splits` CTAs shares one 128 x BN
// tile, CTA r taking the r-th of `splits` contiguous runs of K chunks.  Each
// writes its partial tile into its own shared memory; after a cluster
// barrier, CTA r sums rows [r R, r R + R) (R = 128 / splits) of every CTA's
// partial through distributed shared memory, in rank order, so the result
// does not depend on timing; then bias, activation, and float4 stores.  A
// last cluster barrier keeps every CTA's shared memory alive until its peers
// have read it.  No workspace in device memory, no atomics.
template <bool kSplit>
__global__ void __launch_bounds__(kWsThreads, 1)
    fused_dense_f32_wgmma(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w, const DenseParams p) {
  using namespace hopper;
  using Cfg = F32Cfg;
  constexpr int BN = kF32BN, kLand = Cfg::kLand;
  extern __shared__ uint8_t f32_smem[];
  F32Smem& sm = *reinterpret_cast<F32Smem*>(
      (reinterpret_cast<uintptr_t>(f32_smem) + 1023) & ~uintptr_t(1023));
  const int tiles_n = (p.N + BN - 1) / BN;
  const int num_tiles = ((p.M + kWM - 1) / kWM) * tiles_n;
  const int num_k = (p.K + kFK - 1) / kFK;
  const int wg = threadIdx.x / 128;
  // The tiles this CTA walks and the K chunks it takes of each.
  int tile0 = blockIdx.x, tile_step = gridDim.x, k_begin = 0, k_end = num_k;
  uint32_t rank = 0, splits = 1;
  if constexpr (kSplit) {
    rank = cluster_ctarank();
    splits = cluster_nctarank();
    tile0 = blockIdx.x / splits;
    tile_step = num_tiles;  // one tile
    k_begin = int((long long)num_k * rank / splits);
    k_end = int((long long)num_k * (rank + 1) / splits);
  }

  if (threadIdx.x == 0) {
    for (int l = 0; l < kLand; ++l) {
      mbar_init(&sm.land_full[l], 1);
      mbar_init(&sm.land_empty[l], kQReleases);
    }
    mbar_init(&sm.empty[0], kQReleases);
    mbar_init(&sm.empty[1], kQReleases);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues TMA, as far ahead as the landing ring allows.
    setmaxnreg_dec<kQuantProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = tile0; tile < num_tiles; tile += tile_step) {
        const int m0 = (tile / tiles_n) * kWM, n0 = (tile % tiles_n) * BN;
        for (int kt = k_begin; kt < k_end; ++kt, ++it) {
          const int l = it % kLand;
          mbar_wait(&sm.land_empty[l], ((it / kLand) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.land_full[l], Cfg::kLandBytes);
          tma_load_2d(sm.land[l], &tm_x, &sm.land_full[l], kt * kFK, m0);
          tma_load_2d(sm.land[l] + Cfg::kLandXBytes, &tm_w, &sm.land_full[l], n0, kt * kFK);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each tile.
    setmaxnreg_inc<kQuantConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int ct = threadIdx.x - 128;  // this thread's index among the converting threads
    const int row_base = 64 * cw;
    const float* bias = static_cast<const float*>(p.b);
    constexpr int kCols = (BN + 127) / 128;  // columns of bias a thread loads
    int it = 0;
    for (int tile = tile0; tile < num_tiles; tile += tile_step) {
      const int m0 = (tile / tiles_n) * kWM, n0 = (tile % tiles_n) * BN;
      float col_bias[kCols];
      if constexpr (!kSplit) {
        // Read before the mainloop so that the latency hides behind it.
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int c = tid + 128 * i;
          col_bias[i] = c < BN && n0 + c < p.N ? bias[n0 + c] : 0.f;
        }
      }
      // acc: the sum over the chunks done, added on the CUDA cores (rounded to
      // nearest); chunk: one K chunk's twelve products, summed by wgmma.
      float acc[BN / 2], chunk[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = chunk[i] = 0.f;

      for (int kt = k_begin; kt < k_end; ++kt, ++it) {
        const int l = it % kLand, s = it % 2;
        mbar_wait(&sm.land_full[l], (it / kLand) & 1);
        mbar_wait(&sm.empty[s], ((it / 2) & 1) ^ 1);
        split_w32<kQConvThreads>(reinterpret_cast<const float*>(sm.land[l] + Cfg::kLandXBytes),
                                     sm.b[s][0], ct);
        split_x32<kQConvThreads>(reinterpret_cast<const float*>(sm.land[l]), sm.a[s], ct);
        // wgmma reads the converted stage, and TMA rewrites the landing
        // stage, through the async proxy: order this thread's generic stores
        // and loads before them, then wait for every converting thread.
        fence_proxy_async();
        named_barrier_sync(3, kQConvThreads);
        if (lane == 0) mbar_arrive(&sm.land_empty[l]);
        // The previous chunk's products are done (their run overlapped this
        // chunk's conversion): add them into acc, and hand their stage back.
        wgmma_wait<0>();
        fence_operand(chunk);
        if (kt > k_begin) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += chunk[i];
          if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % 2]);
        }
        const __nv_bfloat16* a = sm.a[s] + row_base * 64;
        fence_operand(chunk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kFK / 16; ++kk) {
          uint64_t db[3];
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            db[part] = make_desc_sw128(sm.b[s][part] + kk * 16 * 64, kFK * 64 * 2, 1024);
          }
          const uint64_t xh = make_desc_sw128(a + kk * 16, 16, 1024);
          const uint64_t xm = make_desc_sw128(a + 32 + kk * 16, 16, 1024);
          const uint64_t xl = make_desc_sw128(a + kWM * 64 + kk * 16, 16, 1024);
          wgmma_ss<1>(chunk, xl, db[0], kk);  // the chunk's first product overwrites
          wgmma_ss<1>(chunk, xh, db[2], 1);
          wgmma_ss<1>(chunk, xm, db[1], 1);
          wgmma_ss<1>(chunk, xm, db[0], 1);
          wgmma_ss<1>(chunk, xh, db[1], 1);
          wgmma_ss<1>(chunk, xh, db[0], 1);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_operand(chunk);
      if (k_end > k_begin) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += chunk[i];
        if (lane == 0) mbar_arrive(&sm.empty[(it - 1) % 2]);
      }

      if constexpr (kSplit) {
        // The partial tile into this CTA's shared memory, over the landing
        // ring and x's parts, once both warpgroups' products are done.
        named_barrier_sync(3, kQConvThreads);
        float* part = reinterpret_cast<float*>(sm.land[0]);
#pragma unroll
        for (int jt = 0; jt < BN / 8; ++jt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row_base + 16 * warp + g + 8 * r;
            *reinterpret_cast<float2*>(part + row * Cfg::kPartLd + 8 * jt + 2 * t) =
                make_float2(acc[4 * jt + 2 * r], acc[4 * jt + 2 * r + 1]);
          }
        }
      } else {
        // Epilogue: acc + bias, the activation in f32, f32 pairs straight
        // from the accumulator: a quad of threads writes 32 contiguous bytes
        // of a row, a full sector.  N is a multiple of 4, so a pair is in or
        // out whole.
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          if (tid + 128 * i < BN) sm.bias[cw][tid + 128 * i] = col_bias[i];
        }
        named_barrier_sync(1 + cw, 128);
        float* out = static_cast<float*>(p.out);
#pragma unroll
        for (int jt = 0; jt < BN / 8; ++jt) {
          const int cl = 8 * jt + 2 * t, col = n0 + cl;
          const float2 b2 = *reinterpret_cast<const float2*>(sm.bias[cw] + cl);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = m0 + row_base + 16 * warp + g + 8 * r;
            if (row < p.M && col < p.N) {
              *reinterpret_cast<float2*>(out + (long long)row * p.N + col) =
                  make_float2(activate(acc[4 * jt + 2 * r] + b2.x, p.act),
                              activate(acc[4 * jt + 2 * r + 1] + b2.y, p.act));
            }
          }
        }
        named_barrier_sync(1 + cw, 128);  // the bias read before the next tile writes it
      }
    }
  }

  if constexpr (kSplit) {
    // Every CTA's partial tile is written (all threads of the cluster take part).
    cluster_sync();
    if (wg > 0) {
      const int m0 = (tile0 / tiles_n) * kWM, n0 = (tile0 % tiles_n) * BN;
      const float* part = reinterpret_cast<const float*>(sm.land[0]);
      const int ct = threadIdx.x - 128;
      switch (splits) {  // a power of two from 2 to 16 (f32_splits)
        case 2: reduce_partials<2>(part, rank, m0, n0, p, ct); break;
        case 4: reduce_partials<4>(part, rank, m0, n0, p, ct); break;
        case 8: reduce_partials<8>(part, rank, m0, n0, p, ct); break;
        default: reduce_partials<16>(part, rank, m0, n0, p, ct); break;
      }
    }
    // No CTA leaves while a peer may still read its shared memory.
    cluster_sync();
  }
}

// ------------------------------------------ bf16 path: unaligned rows (mma.sync)

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N, 64x32 each
constexpr int kALd = kBK + 8;       // 80-byte rows of the x tile
constexpr int kBLd = kBN + 8;       // 272-byte rows of the w tile
constexpr int kStages = 2;

struct SmemBf16 {
  __nv_bfloat16 a[kStages][kBM * kALd];
  __nv_bfloat16 b[kStages][kBK * kBLd];
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// c += a * b for one 16x8x16 tile (g = lane / 4, t = lane % 4):
//   a[0]: (row g, k 2t..2t+1)  a[1]: (row g+8, k 2t..)  a[2]: (row g, k 2t+8..)  a[3]: (row g+8, k 2t+8..)
//   b0: (k 2t..2t+1, n g)      b1: (k 2t+8..2t+9, n g)
//   c[0..1]: (row g, n 2t..2t+1)  c[2..3]: (row g+8, n 2t..2t+1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the x tile [m0:m0+128, k0:k0+32] and the w tile [k0:k0+32, n0:n0+128]
// element by element; zeros past M, N and K.
__device__ __forceinline__ void load_tiles_bf16(SmemBf16& sm, int stage, const DenseParams& p,
                                                int m0, int n0, int k0) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* sa = sm.a[stage];
  __nv_bfloat16* sb = sm.b[stage];
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
    const int r = e / kBK, c = e % kBK;
    sa[r * kALd + c] =
        (m0 + r < p.M && k0 + c < p.K) ? x[(long long)(m0 + r) * p.ldx + k0 + c] : zero;
  }
  for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
    const int r = e / kBN, c = e % kBN;
    sb[r * kBLd + c] =
        (k0 + r < p.K && n0 + c < p.N) ? w[(long long)(k0 + r) * p.ldw + n0 + c] : zero;
  }
}

__global__ void __launch_bounds__(kThreads) fused_dense_bf16(const DenseParams p) {
  __shared__ __align__(16) SmemBf16 sm;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // this warp's corner in the tile
  const int g = lane >> 2, t = lane & 3;

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int num_k = (p.K + kBK - 1) / kBK;
  if (num_k > 0) load_tiles_bf16(sm, 0, p, m0, n0, 0);
  for (int kt = 0; kt < num_k; ++kt) {
    // Stage (kt + 1) & 1 was last read in step kt - 1, behind its closing barrier.
    if (kt + 1 < num_k) load_tiles_bf16(sm, (kt + 1) & 1, p, m0, n0, (kt + 1) * kBK);
    __syncthreads();  // stage kt is written
    const __nv_bfloat16* sa = sm.a[kt & 1];
    const __nv_bfloat16* sb = sm.b[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldmatrix_x4(af[mi], sa + (wm + mi * 16 + (lane % 16)) * kALd + kk + (lane / 16) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb + (kk + (lane % 16)) * kBLd + wn + nj * 16 + (lane / 16) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    __syncthreads();  // every warp is done with stage kt before it is refilled
  }

  // Epilogue: bias, activation, bf16 store of (row, col) and (row, col + 1).
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.b);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const bool paired = (p.N % 2) == 0;  // col is even, so a bf16 pair is 4-byte aligned
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t;
    if (col >= p.N) continue;
    const float b0 = __bfloat162float(bias[col]);
    const float b1 = col + 1 < p.N ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        if (row >= p.M) continue;
        const float v0 = activate(acc[mi][ni][2 * h] + b0, p.act);
        const float v1 = activate(acc[mi][ni][2 * h + 1] + b1, p.act);
        __nv_bfloat16* o = out + (long long)row * p.N + col;
        if (paired) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (col + 1 < p.N) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ------------------------------------ f32 and int8 paths, rows TMA cannot read (CUDA cores)

constexpr int kSBM = 64, kSBN = 64, kSBK = 16;
constexpr int kSPad = 4;  // keeps float4 rows 16-byte aligned

// TX: x, b and out; TW: w (float, or int8 with a per-column scale).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) fused_dense_simt(const DenseParams p) {
  __shared__ __align__(16) float sa[kSBK][kSBM + kSPad];  // x tile, transposed: [k][m]
  __shared__ __align__(16) float sb[kSBK][kSBN + kSPad];  // w tile: [k][n]
  const TX* x = static_cast<const TX*>(p.x);
  const TW* w = static_cast<const TW*>(p.w);
  const int n0 = blockIdx.x * kSBN, m0 = blockIdx.y * kSBM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // rows ty*4.., cols tx*4..

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kSBK) {
#pragma unroll
    for (int i = 0; i < (kSBM * kSBK) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kSBK, c = e % kSBK;
      sa[c][r] = (m0 + r < p.M && k0 + c < p.K) ? to_f32(x[(long long)(m0 + r) * p.ldx + k0 + c])
                                                : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kSBK * kSBN) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kSBN, c = e % kSBN;
      float v = 0.f;
      if (k0 + r < p.K && n0 + c < p.N) {
        v = to_f32(w[(long long)(k0 + r) * p.ldw + n0 + c]);
        if (p.scale != nullptr) v *= p.scale[n0 + c];  // f32(wq) * scale, as _quant_kernel
      }
      sb[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sb[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const TX* bias = static_cast<const TX*>(p.b);
  TX* out = static_cast<TX*>(p.out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    if (col >= p.N) continue;
    const float bj = to_f32(bias[col]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row < p.M) store(out + (long long)row * p.N + col, activate(acc[i][j] + bj, p.act));
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int bm, int bn, cudaStream_t stream, const DenseParams& p) {
  const dim3 grid((p.N + bn - 1) / bn, (p.M + bm - 1) / bm);
  kernel<<<grid, kThreads, 0, stream>>>(p);
  return int(cudaGetLastError());
}

// The current device's SM count, asked once per device.
int num_sms() {
  static std::atomic<int> known[64];  // 0: not asked yet
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 64 && (sms = known[dev].load(std::memory_order_relaxed)) > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0) {
    return 132;
  }
  if (dev < 64) known[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

enum Variant {
  kSimt = 0,
  kMmaSync = 1,
  kCoop192 = 2,
  kPingpong128 = 3,
  kF32Coop192 = 4,
  kF32SplitK192 = 5
};

// The wgmma kernel for an M x N output.  With at least two 128 x 128 tiles
// for every SM, ping-pong: one warpgroup's epilogue runs under the other's
// products.  Otherwise cooperative 128 x 192: fewer, wider tiles, each
// reading less of x and w a product.
Variant wgmma_variant(int M, int N) {
  const long long tiles = (long long)((M + kWM - 1) / kWM) * ((N + 127) / 128);
  return tiles >= 2LL * num_sms() ? kPingpong128 : kCoop192;
}

// The f32 tensor-core kernel's split of K.  Where its 128 x 192 tiles would
// leave at least half the SMs idle, a cluster of `splits` CTAs shares each
// tile: the largest power of two up to 16 such that every CTA has an SM of
// its own (tiles x splits <= SMs), takes at least two K chunks, and every
// cluster runs at once (the device's occupancy query for clusters of that
// size, which counts how clusters fit its GPCs: on an H100 SXM 7 clusters of
// 16 CTAs, 15 of 8).  1: no split.  At the ResNet-50 head, 6 tiles: 16.
int max_active_f32_clusters(int splits);

int f32_splits(int M, int N, int K) {
  const long long tiles = (long long)((M + kWM - 1) / kWM) * ((N + kF32BN - 1) / kF32BN);
  const int num_k = (K + kFK - 1) / kFK, sms = num_sms();
  int s = 1;
  while (2 * s <= kMaxSplits && tiles * 2 * s <= sms && num_k >= 2 * s * kMinSplitChunks) s *= 2;
  while (s > 1 && max_active_f32_clusters(s) < tiles) s /= 2;
  return s;
}

// bf16: the wgmma kernel where TMA can read the rows (16-byte-aligned bases
// and row strides, K and N multiples of 8, K > 0), mma.sync otherwise.  f32:
// the tensor-core kernel where TMA can read the rows (16-byte-aligned bases
// and row strides, K > 0) and N is a multiple of 4 (the epilogues' float2
// and float4 stores), split-K where f32_splits says so; CUDA cores otherwise.
// *splits is the f32 split of K (1 for the other variants).
Variant dense_variant(const void* x, const void* w, int M, int N, int K, long long ldx,
                      long long ldw, int is_bf16, int* splits) {
  *splits = 1;
  if (!is_bf16) {
    const bool tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldx % 4 == 0 && ldw % 4 == 0 &&
                     N % 4 == 0 && K > 0;
    if (!tma) return kSimt;
    *splits = f32_splits(M, N, K);
    return *splits > 1 ? kF32SplitK192 : kF32Coop192;
  }
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldx % 8 == 0 &&
                       ldw % 8 == 0 && K % 8 == 0 && N % 8 == 0 && K > 0;
  return aligned ? wgmma_variant(M, N) : kMmaSync;
}

template <int BN, bool kPingpong>
int launch_wgmma(cudaStream_t stream, const DenseParams& p) {
  using Cfg = DenseCfg<BN, kPingpong>;
  CUtensorMap tx, tw, tout;
  const cuuint64_t x_dims[2] = {cuuint64_t(p.K), cuuint64_t(p.M)};
  const cuuint64_t x_strides[1] = {cuuint64_t(p.ldx) * 2};
  const cuuint32_t x_box[2] = {kWK, kWM};
  const cuuint64_t w_dims[2] = {cuuint64_t(p.N), cuuint64_t(p.K)};
  const cuuint64_t w_strides[1] = {cuuint64_t(p.ldw) * 2};
  const cuuint32_t w_box[2] = {64, kWK};
  const cuuint64_t o_dims[2] = {cuuint64_t(p.N), cuuint64_t(p.M)};
  const cuuint64_t o_strides[1] = {cuuint64_t(p.N) * 2};
  const cuuint32_t o_box[2] = {64, Cfg::kRows};
  if (!hopper::cached_tensor_map_bf16<2>(&tx, p.x, x_dims, x_strides, x_box) ||
      !hopper::cached_tensor_map_bf16<2>(&tw, p.w, w_dims, w_strides, w_box) ||
      !hopper::cached_tensor_map_bf16<2>(&tout, p.out, o_dims, o_strides, o_box)) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = smem_wgmma<BN, kPingpong>();
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err =
      hopper::set_max_dynamic_smem_once(smem_set, fused_dense_wgmma<BN, kPingpong>, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((p.N + BN - 1) / BN) * ((p.M + kWM - 1) / kWM);
  const int sms = num_sms();
  const int grid = int(tiles < sms ? tiles : sms);
  fused_dense_wgmma<BN, kPingpong><<<grid, kWsThreads, smem, stream>>>(tx, tw, tout, p);
  return int(cudaGetLastError());
}

template <bool kSplit>
int launch_f32_wgmma(cudaStream_t stream, const DenseParams& p, int splits) {
  CUtensorMap tx, tw;
  const cuuint64_t x_dims[2] = {cuuint64_t(p.K), cuuint64_t(p.M)};
  const cuuint64_t x_strides[1] = {cuuint64_t(p.ldx) * 4};
  const cuuint32_t x_box[2] = {kFK, kWM};
  const cuuint64_t w_dims[2] = {cuuint64_t(p.N), cuuint64_t(p.K)};
  const cuuint64_t w_strides[1] = {cuuint64_t(p.ldw) * 4};
  const cuuint32_t w_box[2] = {kF32BN, kFK};
  if (!hopper::cached_tensor_map<2>(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                    CU_TENSOR_MAP_SWIZZLE_NONE, p.x, x_dims, x_strides, x_box) ||
      !hopper::cached_tensor_map<2>(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                    CU_TENSOR_MAP_SWIZZLE_NONE, p.w, w_dims, w_strides, w_box)) {
    return int(cudaErrorInvalidValue);
  }
  constexpr size_t smem = smem_f32();
  static_assert(smem <= 227 * 1024, "over the 227 KB a block may use");
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err =
      hopper::set_max_dynamic_smem_once(smem_set, fused_dense_f32_wgmma<kSplit>, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((p.N + kF32BN - 1) / kF32BN) * ((p.M + kWM - 1) / kWM);
  if constexpr (kSplit) {
    err = hopper::launch_cluster(fused_dense_f32_wgmma<true>, int(tiles * splits), splits,
                                 kWsThreads, smem, stream, tx, tw, p);
    return err != cudaSuccess ? int(err) : int(cudaGetLastError());
  } else {
    const int sms = num_sms();
    const int grid = int(tiles < sms ? tiles : sms);
    fused_dense_f32_wgmma<false><<<grid, kWsThreads, smem, stream>>>(tx, tw, p);
    return int(cudaGetLastError());
  }
}

// The occupancy query behind f32_splits, asked once per device and size.
int max_active_f32_clusters(int splits) {
  static std::atomic<int> known[64][kMaxSplits + 1];  // 0: not asked yet; the answer + 1
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64) {
    const int k = known[dev][splits].load(std::memory_order_relaxed);
    if (k > 0) return k - 1;
  }
  constexpr size_t smem = smem_f32();
  auto kernel = fused_dense_f32_wgmma<true>;
  static std::atomic<uint64_t> attrs_set{0};
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(attrs_set.load(std::memory_order_acquire) & bit)) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)) !=
            cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
            cudaSuccess) {
      (void)cudaGetLastError();
      return 0;
    }
    attrs_set.fetch_or(bit, std::memory_order_release);
  }
  const int n = hopper::max_active_clusters(kernel, splits, kWsThreads, smem);
  if (dev < 64) known[dev][splits].store(n + 1, std::memory_order_relaxed);
  return n;
}

// Codes of the int8-weight launcher: the CUDA-core kernel, or the wgmma one
// (cooperative 128 x 192) with one bf16 part of x (bf16 x) or three (f32 x).
enum QuantVariant { kQuantSimt = 0, kQuantX1Coop192 = 1, kQuantX3Coop192 = 2 };

// The wgmma route where TMA can describe the operands: x and wq bases on 16
// bytes, x rows and wq rows a multiple of 16 bytes apart, N a multiple of 16
// (the f32 epilogue's pairs, the bf16 output's TMA rows), K > 0.
QuantVariant quant_variant(const void* x, const void* wq, int N, int K, long long ldx,
                           long long ldw, int x_is_bf16) {
  const long long x_row_bytes = ldx * (x_is_bf16 ? 2 : 4);
  const bool tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0 && x_row_bytes % 16 == 0 &&
                   ldw % 16 == 0 && N % 16 == 0 && K > 0;
  if (!tma) return kQuantSimt;
  return x_is_bf16 ? kQuantX1Coop192 : kQuantX3Coop192;
}

template <int kParts>
int launch_quant_wgmma(cudaStream_t stream, const DenseParams& p) {
  CUtensorMap tx, tw, tout;
  const cuuint64_t x_dims[2] = {cuuint64_t(p.K), cuuint64_t(p.M)};
  const cuuint64_t x_strides[1] = {cuuint64_t(p.ldx) * (kParts == 1 ? 2 : 4)};
  const cuuint32_t x_box[2] = {kWK, kWM};
  const cuuint64_t w_dims[2] = {cuuint64_t(p.N), cuuint64_t(p.K)};
  const cuuint64_t w_strides[1] = {cuuint64_t(p.ldw)};
  const cuuint32_t w_box[2] = {kQBN, kWK};
  bool ok = hopper::cached_tensor_map<2>(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                         CU_TENSOR_MAP_SWIZZLE_NONE, p.w, w_dims, w_strides, w_box);
  if constexpr (kParts == 1) {
    const cuuint64_t o_dims[2] = {cuuint64_t(p.N), cuuint64_t(p.M)};
    const cuuint64_t o_strides[1] = {cuuint64_t(p.N) * 2};
    const cuuint32_t o_box[2] = {64, 64};
    ok = ok && hopper::cached_tensor_map_bf16<2>(&tx, p.x, x_dims, x_strides, x_box) &&
         hopper::cached_tensor_map_bf16<2>(&tout, p.out, o_dims, o_strides, o_box);
  } else {
    ok = ok && hopper::cached_tensor_map<2>(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                            CU_TENSOR_MAP_SWIZZLE_NONE, p.x, x_dims, x_strides,
                                            x_box);
    tout = tx;  // unused: the f32 epilogue stores from registers
  }
  if (!ok) return int(cudaErrorInvalidValue);
  const size_t smem = smem_quant<kParts>();
  static_assert(smem_quant<kParts>() <= 227 * 1024, "over the 227 KB a block may use");
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err =
      hopper::set_max_dynamic_smem_once(smem_set, fused_dense_quant_wgmma<kParts>, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((p.N + kQBN - 1) / kQBN) * ((p.M + kWM - 1) / kWM);
  const int sms = num_sms();
  const int grid = int(tiles < sms ? tiles : sms);
  fused_dense_quant_wgmma<kParts><<<grid, kWsThreads, smem, stream>>>(tx, tw, tout, p);
  return int(cudaGetLastError());
}

bool valid(int M, int N, int K, int act) {
  return M > 0 && N > 0 && K >= 0 && act >= kNone && act <= kGelu && (M + kSBM - 1) / kSBM < 65536;
}

}  // namespace

// x [M,K], w [K,N], b [N], all bf16 (is_bf16) or all f32; out [M,N] contiguous,
// in the same dtype.  Row strides in elements.  act: 0 none, 1 relu, 2 gelu
// (tanh form).  Returns the cudaError_t of the launch (0 = success) and, in
// *variant, which kernel it launched (enum Variant).
extern "C" int fused_dense(const void* x, const void* w, const void* b, void* out, int M, int N,
                           int K, long long ldx, long long ldw, int act, int is_bf16,
                           void* stream, int* variant) {
  if (!valid(M, N, K, act)) return int(cudaErrorInvalidValue);
  DenseParams p{x, w, b, nullptr, out, M, N, K, ldx, ldw, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int splits = 1;
  *variant = dense_variant(x, w, M, N, K, ldx, ldw, is_bf16, &splits);
  switch (*variant) {
    case kPingpong128: return launch_wgmma<128, true>(st, p);
    case kCoop192: return launch_wgmma<192, false>(st, p);
    case kMmaSync: return launch(fused_dense_bf16, kBM, kBN, st, p);
    case kF32SplitK192: return launch_f32_wgmma<true>(st, p, splits);
    case kF32Coop192: return launch_f32_wgmma<false>(st, p, 1);
    default: return launch(fused_dense_simt<float, float>, kSBM, kSBN, st, p);
  }
}

// How many CTAs of a cluster the f32 tensor-core kernel splits K over for an
// [M,K] x [K,N] product on the current device (1: no split), by the rule of
// f32_splits; for the record, the launcher does not call it.
extern "C" int fused_dense_f32_splits(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 ? f32_splits(M, N, K) : 1;
}

// x [M,K] and b [N] bf16 (x_is_bf16) or f32; wq [K,N] int8; scale [N] f32;
// out [M,N] contiguous in x's dtype.  Returns the cudaError_t of the launch
// and, in *variant, which kernel it launched (enum QuantVariant).
extern "C" int fused_dense_quantized(const void* x, const void* wq, const void* scale,
                                     const void* b, void* out, int M, int N, int K,
                                     long long ldx, long long ldw, int act, int x_is_bf16,
                                     void* stream, int* variant) {
  if (!valid(M, N, K, act) || scale == nullptr) return int(cudaErrorInvalidValue);
  DenseParams p{x, wq, b, static_cast<const float*>(scale), out, M, N, K, ldx, ldw, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *variant = quant_variant(x, wq, N, K, ldx, ldw, x_is_bf16);
  switch (*variant) {
    case kQuantX1Coop192: return launch_quant_wgmma<1>(st, p);
    case kQuantX3Coop192: return launch_quant_wgmma<3>(st, p);
    default:
      if (x_is_bf16) return launch(fused_dense_simt<__nv_bfloat16, int8_t>, kSBM, kSBN, st, p);
      return launch(fused_dense_simt<float, int8_t>, kSBM, kSBN, st, p);
  }
}
