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
// each do 2*M*N*K = 19.3 GFLOP, 19.5 us at the bf16 peak, and must move
// 36.2 MB (x, w and b read once, out written once), 10.8 us: compute-bound.
// The quantized kernel at mlp_in does the same 19.3 GFLOP at the f32 peak,
// 288 us, against 33.7 MB (10 us): compute-bound too.
//
// Design (first version: right and simple; wgmma, TMA and warp
// specialisation are later work).
//   - The TPU kernel holds the whole K axis of a 256-row tile in VMEM.  A
//     Hopper block cannot (a 64-row bf16 x tile at K 3072 is 384 KB against
//     227 KB of shared memory), so a block owns one output tile and loops over
//     K in chunks through shared memory, into one f32 accumulator per element.
//   - bf16: 128x128 output tile, 8 warps of 64x32, K chunks of 32.  Tiles are
//     double-buffered with cp.async (16-byte copies, zero-filled past the
//     matrix edge) when the rows are 16-byte aligned, and loaded element by
//     element with bounds checks otherwise (ragged N or K, odd strides).
//     Fragments come from shared memory through ldmatrix (x4 for A, x4.trans
//     for B, which reads the row-major w [K,N] as the column-major operand
//     mma wants); mma.sync m16n8k16, bf16 in, f32 accumulate.  Rows are padded
//     by 16 bytes so neither the copies nor ldmatrix conflict on banks.
//   - f32 and int8: 64x64 output tile, 256 threads of 4x4 outputs, K chunks
//     of 16, on CUDA cores (no TF32).  The loader converts each element to
//     f32 on its way into shared memory; for int8 it multiplies by the
//     column's scale there, so the weight crosses device memory as int8.
//   - The epilogue stays in registers: bias (read in the storage dtype, added
//     in f32), activation in f32, cast, bounds-checked store.  M, N and K
//     need no padding: the TPU kernel's jnp.pad copies are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------- bf16 path

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N, 64x32 each
constexpr int kALd = kBK + 8;       // 80-byte rows of the x tile
constexpr int kBLd = kBN + 8;       // 272-byte rows of the w tile
constexpr int kStages = 2;

struct SmemBf16 {
  __nv_bfloat16 a[kStages][kBM * kALd];
  __nv_bfloat16 b[kStages][kBK * kBLd];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: nothing is read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

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

// Stage the x tile [m0:m0+128, k0:k0+32] and the w tile [k0:k0+32, n0:n0+128];
// zeros past M, N and K.  kAligned: every row starts on 16 bytes and K, N are
// multiples of 8, so a 16-byte chunk lies wholly inside or wholly outside.
template <bool kAligned>
__device__ __forceinline__ void load_tiles_bf16(SmemBf16& sm, int stage, const DenseParams& p,
                                                int m0, int n0, int k0) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* sa = sm.a[stage];
  __nv_bfloat16* sb = sm.b[stage];
  if (kAligned) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 8) / kThreads; ++i) {  // 2 chunks a thread
      const int c = threadIdx.x + i * kThreads;
      const int r = c / (kBK / 8), cc = (c % (kBK / 8)) * 8;
      const bool ok = m0 + r < p.M && k0 + cc < p.K;
      cp_async16(sa + r * kALd + cc, ok ? x + (long long)(m0 + r) * p.ldx + k0 + cc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN / 8) / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / (kBN / 8), cc = (c % (kBN / 8)) * 8;
      const bool ok = k0 + r < p.K && n0 + cc < p.N;
      cp_async16(sb + r * kBLd + cc, ok ? w + (long long)(k0 + r) * p.ldw + n0 + cc : w, ok);
    }
  } else {
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
}

template <bool kAligned>
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
  load_tiles_bf16<kAligned>(sm, 0, p, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < num_k; ++kt) {
    if (kt + 1 < num_k) load_tiles_bf16<kAligned>(sm, (kt + 1) & 1, p, m0, n0, (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait_1();  // every group but the newest has landed: stage kt is ready
    __syncthreads();
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
  asm volatile("cp.async.wait_all;\n" ::);  // K == 0 leaves the first (zero-fill) group pending

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

// ------------------------------------------------- f32 and int8 path (CUDA cores)

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

bool valid(int M, int N, int K, int act) {
  return M > 0 && N > 0 && K >= 0 && act >= kNone && act <= kGelu && (M + kSBM - 1) / kSBM < 65536;
}

}  // namespace

// x [M,K], w [K,N], b [N], all bf16 (is_bf16) or all f32; out [M,N] contiguous,
// in the same dtype.  Row strides in elements.  act: 0 none, 1 relu, 2 gelu
// (tanh form).  Returns the cudaError_t of the launch (0 = success).
extern "C" int fused_dense(const void* x, const void* w, const void* b, void* out, int M, int N,
                           int K, long long ldx, long long ldw, int act, int is_bf16,
                           void* stream) {
  if (!valid(M, N, K, act)) return int(cudaErrorInvalidValue);
  DenseParams p{x, w, b, nullptr, out, M, N, K, ldx, ldw, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldx % 8 == 0 &&
                         ldw % 8 == 0 && K % 8 == 0 && N % 8 == 0;
    if (aligned) return launch(fused_dense_bf16<true>, kBM, kBN, st, p);
    return launch(fused_dense_bf16<false>, kBM, kBN, st, p);
  }
  return launch(fused_dense_simt<float, float>, kSBM, kSBN, st, p);
}

// x [M,K] and b [N] bf16 (x_is_bf16) or f32; wq [K,N] int8; scale [N] f32;
// out [M,N] contiguous in x's dtype.  The product is f32 on CUDA cores.
extern "C" int fused_dense_quantized(const void* x, const void* wq, const void* scale,
                                     const void* b, void* out, int M, int N, int K,
                                     long long ldx, long long ldw, int act, int x_is_bf16,
                                     void* stream) {
  if (!valid(M, N, K, act) || scale == nullptr) return int(cudaErrorInvalidValue);
  DenseParams p{x, wq, b, static_cast<const float*>(scale), out, M, N, K, ldx, ldw, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) return launch(fused_dense_simt<__nv_bfloat16, int8_t>, kSBM, kSBN, st, p);
  return launch(fused_dense_simt<float, int8_t>, kSBM, kSBN, st, p);
}
