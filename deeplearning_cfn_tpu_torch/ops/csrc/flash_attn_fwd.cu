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
// through the strides given (no transposed copies); LSE [B, Hq, Sq] f32 in
// natural-log units.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the Llama
// m435 training shape (B=8, S=2048, Hq=Hkv=8, D=128, causal) the forward does
// 4*B*H*D*S*(S+1)/2 = 68.7 GFLOP, 0.070 ms at peak, and must move 134 MB of
// q, k, v and out (+0.5 MB of lse), 0.040 ms.  So it is compute-bound: the
// tensor cores, fed by wgmma, and the exponentials (MUFU, 16 a clock per SM)
// are the two resources.
//
// Design (bf16).  One CTA of three warpgroups per (128-row q tile, head,
// batch):
//   - warpgroup 0 is the producer: it gives up registers (setmaxnreg 24) and
//     one thread issues TMA loads from tensor maps over [B, S, H, D] (dims
//     D, S, H, B; the strides the wrapper passes).  Q is loaded once; K and V
//     tiles of 128 keys go through a 2-stage ring, each stage with a "full"
//     mbarrier (TMA's transaction count) and an "empty" one (one arrival per
//     consumer warp).  K and V have separate barriers, so S = Q K^T starts
//     while V is still in flight.  TMA zero-fills rows past Sq and Sk.
//   - warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 q rows each.
//     S = Q K^T is wgmma m64n128k16 SS: Q and K both K-major in shared memory.
//     O += P V is wgmma RS: P is rounded to bf16 in registers straight from
//     the S accumulator (its layout is the mma.m16n8k16 A fragment's), and V
//     is the N-major B operand, read with the transpose bit, so nothing is
//     copied transposed.
//   - Shared memory at D 128: Q 32 KB + K 2 x 32 KB + V 2 x 32 KB = 160 KB,
//     each tile as D/64 column blocks of [128][64] bf16 (128-byte swizzle).
//   - Softmax: the running max is kept in log2 units, so p = exp2(s * c - m)
//     with c = sm_scale * log2(e) is one FFMA and one MUFU.EX2; lse is
//     converted back to natural-log units at the end.  Masks are evaluated
//     only on a tile that crosses the causal diagonal or the Sk edge; a
//     masked score is -inf, which leaves the running max where it was and
//     gives p = 0, the semantics of the NEG_INF fill.  Row max and row sum
//     are reduced across the four threads of a quad (the sum once, at the end).
//   - The output is staged in the warpgroup's rows of the Q tile, which are
//     free after its last S product, and written with TMA stores.
//   - Under the causal mask the q tile is the slowest index of the linear
//     block id, counted down: the heaviest tiles start first and the lightest
//     fill the last wave.
// What the earlier mma.sync kernel lost, and where it went: synchronous
// global -> register -> shared copies between two __syncthreads (now TMA,
// overlapped with the products through the ring); V fragments from 16-bit
// shared loads (now read by wgmma from the swizzled tile); a mask and a
// separate scale multiply on every element (now only on edge tiles, one
// FFMA); mma.sync on 64-row tiles (now wgmma).  The two consumer warpgroups
// overlap one's softmax with the other's products only as the warp
// scheduler interleaves them; an explicit ping-pong is later work.
//
// f32 inputs take a scalar path (same algorithm, CUDA cores), kept for tests.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

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

constexpr int kThreads = 128;  // f32 path

// ---------------------------------------------------------------- bf16 path

constexpr int kBM = 128;       // q rows per CTA, 64 per consumer warpgroup
constexpr int kBN = 128;       // keys per K/V tile
constexpr int kStages = 2;
constexpr int kWsThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;

template <int D>
struct __align__(1024) FlashSmem {
  __nv_bfloat16 q[D * kBM];            // D/64 column blocks of [kBM][64]
  __nv_bfloat16 k[kStages][D * kBN];   // D/64 column blocks of [kBN][64]
  __nv_bfloat16 v[kStages][D * kBN];
  uint64_t q_full;
  uint64_t k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages];
};

template <int D>
constexpr size_t smem_wgmma() {
  return sizeof(FlashSmem<D>) + 1024;  // + room to align the base to 1024 bytes
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                    const Params p) {
  using namespace hopper;
  constexpr int kBlocks = D / 64;                        // 64-column blocks of a row
  constexpr uint32_t kTileBytes = kBN * D * sizeof(__nv_bfloat16);
  extern __shared__ uint8_t flash_smem[];
  FlashSmem<D>& sm = *reinterpret_cast<FlashSmem<D>*>(
      (reinterpret_cast<uintptr_t>(flash_smem) + 1023) & ~uintptr_t(1023));

  const int n_qtiles = (p.Sq + kBM - 1) / kBM;
  const int bh = blockIdx.x % (p.B * p.Hq);
  const int step = blockIdx.x / (p.B * p.Hq);
  const int q0 = (p.causal ? n_qtiles - 1 - step : step) * kBM;
  const int h = bh % p.Hq, b = bh / p.Hq;
  const int hk = h / p.group;
  const int n_tiles = (kv_end(p, q0, kBM) + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumerWarps);
      mbar_init(&sm.v_empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kBM * D * sizeof(__nv_bfloat16));
      for (int c = 0; c < kBlocks; ++c) {
        tma_load_4d(sm.q + c * kBM * 64, &tm_q, &sm.q_full, c * 64, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;
        mbar_wait(&sm.k_empty[s], parity);
        mbar_arrive_expect_tx(&sm.k_full[s], kTileBytes);
        for (int c = 0; c < kBlocks; ++c) {
          tma_load_4d(sm.k[s] + c * kBN * 64, &tm_k, &sm.k_full[s], c * 64, j * kBN, hk, b);
        }
        mbar_wait(&sm.v_empty[s], parity);
        mbar_arrive_expect_tx(&sm.v_full[s], kTileBytes);
        for (int c = 0; c < kBlocks; ++c) {
          tma_load_4d(sm.v[s] + c * kBN * 64, &tm_v, &sm.v_full[s], c * 64, j * kBN, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows q0 + 64 cw .. + 63
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + 64 * cw + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const int wg_row0 = q0 + 64 * cw;
    const float c = p.scale * kLog2e;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of s * c (log2 units)
    float l[2] = {0.f, 0.f};          // this thread's part of the running sum

    mbar_wait(&sm.q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int n0 = j * kBN;

      // S = Q K^T, 64 x 128 f32.
      float sacc[kBN / 2];
      mbar_wait(&sm.k_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cb = kk / 4, ko = (kk % 4) * 16;
        const uint64_t da = make_desc_sw128(sm.q + cb * kBM * 64 + 64 * cw * 64 + ko, 16, 1024);
        const uint64_t db = make_desc_sw128(sm.k[s] + cb * kBN * 64 + ko, 16, 1024);
        wgmma_ss<0>(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sacc);
      if (lane == 0) mbar_arrive(&sm.k_empty[s]);

      // Masks only where the tile crosses the Sk edge or the causal diagonal.
      const bool edge = n0 + kBN > p.Sk || (p.causal && n0 + kBN - 1 > wg_row0);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int col = n0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = row0 + 8 * ((i >> 1) & 1);
          if (!key_valid(p, col, row)) sacc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
      float shift[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * c);
        // A row with no valid key yet keeps m = NEG_INF: exp(NEG_INF - NEG_INF)
        // would be 1, so the shift is clamped to 0 there.
        shift[r] = m_new <= kNegInf / 2 ? 0.f : m_new;
        alpha[r] = m[r] <= kNegInf / 2 ? 0.f : fast_exp2(m[r] - shift[r]);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float pv = fast_exp2(fmaf(sacc[i], c, -shift[r]));
        sacc[i] = pv;
        rs[r] += pv;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // P as bf16 A fragments: k-step kk covers keys 16kk .. 16kk + 15.
      uint32_t pf[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pf[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }

      // O += P V.
      mbar_wait(&sm.v_full[s], parity);
      fence_operand(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t db = make_desc_sw128(sm.v[s] + kk * 16 * 64, kBN * 64 * 2, 1024);
        wgmma_rs<1>(o, pf[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(o);
      fence_operand(pf);
      if (lane == 0) mbar_arrive(&sm.v_empty[s]);
    }

    // out = acc / l (l == 0 -> out 0), lse = m + log(l) (l == 0 -> NEG_INF).
    // The warpgroup's 64 rows of the Q tile are free once its last S product
    // has completed; laid out as a 128-byte-swizzled TMA box, they stage the
    // bf16 output (conflict-free writes), and one thread stores them with
    // TMA, which clips rows past Sq (direct 4-byte stores from the
    // accumulator layout would write half sectors).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    uint8_t* staging = reinterpret_cast<uint8_t*>(sm.q);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = 64 * cw + 16 * warp + g + 8 * r;  // row in the Q tile
      const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int jt = 0; jt < D / 8; ++jt) {
        *reinterpret_cast<uint32_t*>(staging + (jt / 8) * (kBM * 128) + rr * 128 +
                                     (((jt % 8) ^ g) * 16) + 4 * t) =
            pack_bf16(o[4 * jt + 2 * r] / denom, o[4 * jt + 2 * r + 1] / denom);
      }
      if (t == 0 && row0 + 8 * r < p.Sq) {
        p.lse[((long long)b * p.Hq + h) * p.Sq + row0 + 8 * r] =
            l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(denom);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + cw, 128);
    if (threadIdx.x % 128 == 0 && wg_row0 < p.Sq) {
      for (int cb = 0; cb < kBlocks; ++cb) {
        tma_store_4d(&tm_o, staging + cb * (kBM * 128) + 64 * cw * 128, cb * 64, wg_row0, h, b);
      }
      tma_store_commit();
      tma_store_wait<0>();
    }
  }
}

// A tensor map over a [B, S, H, D] bf16 tensor (strides in elements), with a
// box of 64 columns x `rows` rows of one head.
bool make_bhsd_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, long long sb,
                   long long ss, long long sh, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(rows), 1, 1};
  return hopper::cached_tensor_map_bf16<4>(map, base, dims, strides, box);
}

template <int D>
int launch_wgmma(cudaStream_t stream, const Params& p) {
  CUtensorMap tq, tk, tv, to;
  if (!make_bhsd_map(&tq, p.q, p.B, p.Sq, p.Hq, D, p.q_sb, p.q_ss, p.q_sh, kBM) ||
      !make_bhsd_map(&tk, p.k, p.B, p.Sk, p.Hkv, D, p.k_sb, p.k_ss, p.k_sh, kBN) ||
      !make_bhsd_map(&tv, p.v, p.B, p.Sk, p.Hkv, D, p.v_sb, p.v_ss, p.v_sh, kBN) ||
      !make_bhsd_map(&to, p.out, p.B, p.Sq, p.Hq, D, p.o_sb, p.o_ss, p.o_sh, kBM / 2)) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = smem_wgmma<D>();
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = hopper::set_max_dynamic_smem_once(smem_set, flash_fwd_wgmma<D>, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)((p.Sq + kBM - 1) / kBM) * p.Hq * p.B;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  flash_fwd_wgmma<D><<<unsigned(blocks), kWsThreads, smem, stream>>>(tq, tk, tv, to, p);
  return int(cudaGetLastError());
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

enum Variant { kSimt = 0, kWgmmaTma = 1 };

}  // namespace

// Strides are in elements.  Returns the cudaError_t of the launch (0 = success)
// and, in *variant, which kernel it launched (enum Variant).  bf16 tensors
// need 16-byte-aligned bases and strides a multiple of 8 elements (TMA's
// rule); the wrapper checks it.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Sq, int Sk, int Hq, int Hkv, int D,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long o_sb, long long o_ss, long long o_sh,
                              float scale, int causal, int is_bf16, void* stream, int* variant) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0) return int(cudaErrorInvalidValue);
  Params p{q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, Hq, Hkv, Hq / Hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *variant = is_bf16 ? kWgmmaTma : kSimt;
  if (is_bf16) {
    if (D == 128) return launch_wgmma<128>(st, p);
    if (D == 64) return launch_wgmma<64>(st, p);
  } else {
    if (D == 128) return launch(flash_fwd_f32<128>, kSBM, smem_f32<128>(), st, p);
    if (D == 64) return launch(flash_fwd_f32<64>, kSBM, smem_f32<64>(), st, p);
  }
  return int(cudaErrorInvalidValue);
}
