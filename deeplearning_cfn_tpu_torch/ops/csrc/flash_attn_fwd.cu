// Flash-attention forward for Hopper (sm_90a), with a plain C launcher for ctypes.
//
// Replaces the Pallas TPU kernel `_attn_kernel`, launched by `_flash_forward`
// in deeplearning_cfn_tpu/ops/pallas_attention.py, and computes what it
// computes: a blockwise online softmax with an f32 running max, denominator
// and accumulator; masked scores at NEG_INF (not -inf), the shift clamped to
// 0 for a row with no valid key yet, and `l == 0` rows giving out 0 and lse
// NEG_INF; the kv padding mask `k_pos < Sk` for any Sk and ragged q rows
// guarded; whole causal kv tiles with k_start > q_end skipped; GQA by
// kv head = h / (Hq / Hkv), no repeat.  Layout [B, S, H, D] read and written
// through the strides given (no transposed copies); LSE [B, Hq, Sq] f32.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the Llama
// m435 training shape (B=8, S=2048, Hq=Hkv=8, D=128, causal) the forward does
// 4*B*H*D*S*(S+1)/2 = 68.7 GFLOP, 69 us at peak, and must move 134 MB of q, k,
// v and out (+0.5 MB of lse), 40 us at peak.  So it is compute-bound.
//
// Design (first version: right and simple; wgmma, TMA and warp specialisation
// are later work).  One block of 4 warps per (64-row q tile, head, batch).
// The TPU kernel's 1024x512 VMEM blocks do not carry over: a Hopper block has
// at most 227 KB of shared memory and 255 registers a thread, so the q tile is
// 64 rows (16 per warp) and the kv loop steps 64 rows at a time.  Q, K and V
// tiles sit in shared memory (rows padded by 16 bytes, so the fragment loads
// below are free of bank conflicts); Q is then held in registers as mma A
// fragments.  S = Q K^T and O += P V run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate); the S accumulator is reused in
// registers as the A operand of P V, so P never leaves registers.  The row
// max and row sum are reduced across the 4 threads of a quad with shuffles.
// f32 inputs take a scalar path (same algorithm, CUDA cores), kept for tests.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, Sq, Sk, Hq, Hkv, group;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ bool key_valid(const Params& p, int col, int row) {
  return col < p.Sk && (!p.causal || col <= row);
}

// Number of kv positions a q tile starting at q0 with `rows` rows must visit:
// causal tiles whose first key is past the tile's last query are skipped.
__device__ __forceinline__ int kv_end(const Params& p, int q0, int rows) {
  return p.causal ? min(p.Sk, q0 + rows) : p.Sk;
}

// ---------------------------------------------------------------- bf16 path

constexpr int kBM = 64;       // q rows per block, 16 per warp
constexpr int kBN = 64;       // kv rows per tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 elements of padding per shared row

template <int D>
constexpr size_t smem_bf16() {
  return size_t(kBM + 2 * kBN) * (D + kPad) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// c += a * b for one 16x8x16 tile.  Fragment layout (g = lane / 4, t = lane % 4):
//   a[0]: (row g,   k 2t..2t+1)   a[1]: (row g+8, k 2t..2t+1)
//   a[2]: (row g,   k 2t+8..+9)   a[3]: (row g+8, k 2t+8..+9)
//   b0:   (k 2t..2t+1,  n g)      b1:   (k 2t+8..2t+9, n g)
//   c[0..1]: (row g, n 2t..2t+1)  c[2..3]: (row g+8, n 2t..2t+1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `rows` rows of D bf16 (16-byte chunks) starting at row r0 of src into a
// padded shared tile; rows at or past n are zero (so masked V rows add 0, never NaN).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row_stride, int r0, int n) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + cc * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + cc * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBM * LD;
  __nv_bfloat16* sV = sK + kBN * LD;

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile_bf16<D, kBM>(sQ, qp, p.q_ss, q0, p.Sq);
  __syncthreads();

  // This thread's two rows within the tile, and Q as A fragments.
  const int r_lo = warp * 16 + g;
  const int qrow[2] = {q0 + r_lo, q0 + r_lo + 8};
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* row0 = sQ + r_lo * LD + kk * 16 + 2 * t;
    const __nv_bfloat16* row1 = row0 + 8 * LD;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(row0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(row1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(row0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(row1 + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int n_end = kv_end(p, q0, kBM);
  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, kBN>(sK, kp, p.k_ss, n0, p.Sk);
    load_tile_bf16<D, kBN>(sV, vp, p.v_ss, n0, p.Sk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys, f32.
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const __nv_bfloat16* kr = sK + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Scale, mask, and the tile's row max (quad-reduced).
    float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const float x = key_valid(p, col, qrow[row]) ? s[nt][e] * p.scale : kNegInf;
        s[nt][e] = x;
        mcur[row] = fmaxf(mcur[row], x);
      }
    }
    float alpha[2], shift[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mcur[row] = fmaxf(mcur[row], __shfl_xor_sync(0xffffffffu, mcur[row], 1));
      mcur[row] = fmaxf(mcur[row], __shfl_xor_sync(0xffffffffu, mcur[row], 2));
      const float m_new = fmaxf(m[row], mcur[row]);
      // A row with no valid key yet keeps m = NEG_INF: exp(NEG_INF - NEG_INF)
      // would be 1, so the shift is clamped to 0 there.
      shift[row] = m_new <= kNegInf / 2 ? 0.f : m_new;
      alpha[row] = m[row] <= kNegInf / 2 ? 0.f : __expf(m[row] - shift[row]);
      m[row] = m_new;
    }

    // P = exp(S - shift) on valid keys, 0 elsewhere; row sums in f32.
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const float pv = key_valid(p, col, qrow[row]) ? __expf(s[nt][e] - shift[row]) : 0.f;
        s[nt][e] = pv;
        rs[row] += pv;
      }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 1);
      rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 2);
      l[row] = alpha[row] * l[row] + rs[row];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V: P (cast to bf16) straight from the S accumulator as A fragments.
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* v0 = sV + (16 * j + 2 * t) * LD + dt * 8 + g;
        const uint32_t b0 = pack_pair(v0[0], v0[LD]);
        const uint32_t b1 = pack_pair(v0[8 * LD], v0[9 * LD]);
        mma_bf16(o[dt], a, b0, b1);
      }
    }
  }

  // out = acc / l (l == 0 -> out 0), lse = m + log(l) (l == 0 -> NEG_INF).
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (qrow[row] >= p.Sq) continue;
    const float denom = l[row] == 0.f ? 1.f : l[row];
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb +
                        (long long)qrow[row] * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_bf16(o[dt][2 * row] / denom, o[dt][2 * row + 1] / denom);
    }
    if (t == 0) {
      p.lse[((long long)b * p.Hq + h) * p.Sq + qrow[row]] =
          l[row] == 0.f ? kNegInf : m[row] + logf(denom);
    }
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int kSBM = 32;  // q rows per block; thread i owns row i / 4
constexpr int kSBN = 32;  // kv rows per tile

template <int D>
constexpr size_t smem_f32() {
  // sQ [32][D], sK [32][D+1], sV [32][D], sS [32][33], sAlpha/sM/sL [32] each
  return sizeof(float) * (size_t(kSBM) * D + kSBN * (D + 1) + kSBN * D + kSBM * 33 + 3 * kSBM);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kSBM * D;
  float* sV = sK + kSBN * (D + 1);
  float* sS = sV + kSBN * D;
  float* sAlpha = sS + kSBM * 33;
  float* sM = sAlpha + kSBM;
  float* sL = sM + kSBM;

  const int q0 = blockIdx.x * kSBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x;
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < kSBM * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sQ[i] = q0 + r < p.Sq ? qp[(long long)(q0 + r) * p.q_ss + d] : 0.f;
  }
  // Row statistics live with thread `row` (< 32); accumulators with threads 4r..4r+3.
  float m_row = kNegInf, l_row = 0.f;
  const int my_row = tid / 4, dq = tid % 4;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  const int n_end = kv_end(p, q0, kSBM);
  for (int n0 = 0; n0 < n_end; n0 += kSBN) {
    __syncthreads();
    for (int i = tid; i < kSBN * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = n0 + r < p.Sk;
      sK[r * (D + 1) + d] = in ? kp[(long long)(n0 + r) * p.k_ss + d] : 0.f;
      sV[i] = in ? vp[(long long)(n0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kSBM * kSBN; e += kThreads) {
      const int r = e / kSBN, c = e % kSBN;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += sQ[r * D + d] * sK[c * (D + 1) + d];
      sS[r * 33 + c] = key_valid(p, n0 + c, q0 + r) ? dot * p.scale : kNegInf;
    }
    __syncthreads();
    if (tid < kSBM) {
      float mcur = kNegInf;
      for (int c = 0; c < kSBN; ++c) mcur = fmaxf(mcur, sS[tid * 33 + c]);
      const float m_new = fmaxf(m_row, mcur);
      const float shift = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float alpha = m_row <= kNegInf / 2 ? 0.f : expf(m_row - shift);
      float rs = 0.f;
      for (int c = 0; c < kSBN; ++c) {
        const float pv = key_valid(p, n0 + c, q0 + tid) ? expf(sS[tid * 33 + c] - shift) : 0.f;
        sS[tid * 33 + c] = pv;
        rs += pv;
      }
      l_row = alpha * l_row + rs;
      m_row = m_new;
      sAlpha[tid] = alpha;
    }
    __syncthreads();
    const float alpha = sAlpha[my_row];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int d = dq + 4 * i;
      float pv = 0.f;
      for (int c = 0; c < kSBN; ++c) pv += sS[my_row * 33 + c] * sV[c * D + d];
      acc[i] = acc[i] * alpha + pv;
    }
  }
  if (tid < kSBM) {
    sM[tid] = m_row;
    sL[tid] = l_row;
  }
  __syncthreads();
  const int qr = q0 + my_row;
  if (qr < p.Sq) {
    const float l = sL[my_row];
    const float denom = l == 0.f ? 1.f : l;
    float* op = static_cast<float*>(p.out) + b * p.o_sb + (long long)qr * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) op[dq + 4 * i] = acc[i] / denom;
    if (dq == 0) {
      p.lse[((long long)b * p.Hq + h) * p.Sq + qr] = l == 0.f ? kNegInf : sM[my_row] + logf(denom);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int rows_per_block, size_t smem, cudaStream_t stream, const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.Sq + rows_per_block - 1) / rows_per_block, p.Hq, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// Strides are in elements.  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Sq, int Sk, int Hq, int Hkv, int D,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long o_sb, long long o_ss, long long o_sh,
                              float scale, int causal, int is_bf16, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0) return int(cudaErrorInvalidValue);
  Params p{q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, Hq, Hkv, Hq / Hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 128) return launch(flash_fwd_bf16<128>, kBM, smem_bf16<128>(), st, p);
    if (D == 64) return launch(flash_fwd_bf16<64>, kBM, smem_bf16<64>(), st, p);
  } else {
    if (D == 128) return launch(flash_fwd_f32<128>, kSBM, smem_f32<128>(), st, p);
    if (D == 64) return launch(flash_fwd_f32<64>, kSBM, smem_f32<64>(), st, p);
  }
  return int(cudaErrorInvalidValue);
}
