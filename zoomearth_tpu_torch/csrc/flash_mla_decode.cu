// K5: single-token latent-attention (MLA) decode over the latent cache, absorbed form,
// hand-written for Hopper. No TPU kernel computes this; the port adds it for Kimi-VL.
//
// Semantics: q (B, 16, 576) holds each head's absorbed query [q^ (512) | q_r (64)];
// the cache (B, 1, T, 576) holds each slot's latent [c (512) | k_r (64)]. Row b attends
// to its first kv_len[b] slots: o_h = sum_t softmax_t(scale q_h . kv_t) c_t, (B, 16, 512).
// The scale is passed in (1/sqrt(192) for Kimi-VL: the logits are those of the
// expanded 192-wide heads), never derived from 576. The cache may be a prefix view of
// a longer one (the decoder's attend_len slice), read through its strides in place.
// A row with kv_len == 0 reads nothing and gets 0.
//
// What bounds it on the card: bytes, with the products close behind. Each latent row
// (1152 bytes) serves 16 heads twice (scores over 576 dims, values over 512): about
// 30 flop a byte, against 3.35 TB/s that is 100 TFLOP/s, beyond the 67 of fp32 FMA. So
// both products run on the tensor cores, and the 16 heads are exactly the m16 of
// mma.sync m16n8k16: the heads are the rows of A, the slots the columns.
//
// What the design does about it:
// - The key axis is split across blocks, as K3's split pass does (decode_split.cuh):
//   the grid is B x nsplit with the split length chosen on the host from the shapes
//   alone (ops/flash_mla_decode.py::split_plan); a block whose split starts at or past
//   its row's live length exits at once, so reads scale with the live slots.
// - A block of four warps streams its split in tiles of K5_TILE = 32 slots through a
//   two-stage ring of cp.async copies (rows padded by 16 bytes for ldmatrix), q staged
//   once. Two blocks fit an SM, so two tiles are in flight on each SM while two compute.
// - Scores: warp w takes the tile's slots 16 (w % 2) .. + 15 over half of the 576 key
//   dims (w / 2), as mma.sync products from shared memory (flash_mma.cuh's
//   mma_rows_abt); the two halves meet in shared memory. Every warp then reads the
//   tile's 32 summed scores of its fragment's rows and takes the same online-softmax
//   step (base 2, the scale folded in), so no warp waits for another's softmax.
// - Values: warp w accumulates output dims 128 w .. + 127 of all 16 heads, P as the A
//   fragments straight from the softmax's registers and the tile's c read transposed
//   by ldmatrix (mma_rows_pv): each staged byte is read once by the score products and
//   once by the value products.
// - Each block leaves its softmax state per head (m, l, acc[512]) in scratch, and the
//   shared split merge (split_merge.cu) combines them: one C call, two launches.
#include "flash_mma.cuh"

namespace zt {

constexpr int K5_HEADS = 16;                   // query heads of a row: the m16 of the products
constexpr int K5_DK = 576;                     // key width: [c | k_r]
constexpr int K5_DV = 512;                     // value width: c
constexpr int K5_TILE = 32;                    // slots per staged tile
constexpr int K5_STAGES = 2;                   // ring depth: one tile in flight while one computes
constexpr int K5_WARPS = 4;
constexpr int K5_THREADS = 32 * K5_WARPS;
constexpr int K5_LD = K5_DK + 8;               // padded row, elements (1168 bytes: 16 apart mod 128)
constexpr int K5_VPR = K5_DK / 8;              // 16-byte vectors per row
constexpr int K5_KHALF = K5_DK / 2;            // key dims of one warp's score product
constexpr int K5_DW = K5_DV / K5_WARPS;        // output dims of one warp
constexpr int K5_SMEM = 2 * (K5_HEADS + K5_STAGES * K5_TILE) * K5_LD + 4 * 2 * K5_HEADS * K5_TILE;

// q (B, 16, 576) through q_sb, q_sh; kv the cache's row b slot t at kv + b kv_sb + t kv_st;
// kv_len (B,) int32; part the split scratch (SplitPartials, pairs = B, G = 16, D = 512).
__global__ void __launch_bounds__(K5_THREADS, 2)
    mla_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kv,
                      const int* __restrict__ kv_len, float* __restrict__ part, int T, int split_len,
                      long long q_sb, long long q_sh, long long kv_sb, long long kv_st, float scale) {
  const int b = blockIdx.x, split = blockIdx.y;
  const int klen = min(kv_len[b], T);
  const int lo = split * split_len;
  if (lo >= klen) return;  // past the row's live slots (or none live): the merge never reads this split
  const int hi = min(lo + split_len, klen);
  const int ntiles = (hi - lo + K5_TILE - 1) / K5_TILE;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* tiles = qs + K5_HEADS * K5_LD;
  float* sc = reinterpret_cast<float*>(tiles + K5_STAGES * K5_TILE * K5_LD);  // [key half][head][slot]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const __nv_bfloat16* kvb = kv + (long long)b * kv_sb;

  // tile i into stage i % K5_STAGES, rows past hi zero-filled; one group per call
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      __nv_bfloat16* dst = tiles + (i % K5_STAGES) * K5_TILE * K5_LD;
      const int t0 = lo + i * K5_TILE;
      for (int e = tid; e < K5_TILE * K5_VPR; e += K5_THREADS) {
        const int row = e / K5_VPR, vec = e % K5_VPR;
        const bool ok = t0 + row < hi;
        cp_async16_z<false>(dst + row * K5_LD + vec * 8, kvb + (long long)(ok ? t0 + row : lo) * kv_st + vec * 8, ok);
      }
    }
    cp_async_commit();
  };

  // the row's queries ride with tile 0's group
  const __nv_bfloat16* qb = q + (long long)b * q_sb;
  for (int e = tid; e < K5_HEADS * K5_VPR; e += K5_THREADS) {
    const int h = e / K5_VPR, vec = e % K5_VPR;
    cp_async16(qs + h * K5_LD + vec * 8, qb + (long long)h * q_sh + vec * 8);
  }
#pragma unroll
  for (int i = 0; i < K5_STAGES - 1; ++i) load_tile(i);

  const int slots = (warp & 1) * 16;  // this warp's slots of the score product
  const int khalf = warp >> 1;        // and its half of the key dims
  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF};  // running max of the raw logits, heads g and g + 8
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  float o[K5_DW / 8][4];
#pragma unroll
  for (int j = 0; j < K5_DW / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<K5_STAGES - 2>();
    __syncthreads();  // tile i has arrived; tile i - 1's stage and the scores are consumed
    load_tile(i + K5_STAGES - 1);
    const __nv_bfloat16* kt = tiles + (i % K5_STAGES) * K5_TILE * K5_LD;
    const int t0 = lo + i * K5_TILE;

    float c[2][4];
    mma_rows_abt<K5_KHALF, 2, K5_LD>(c, qs + khalf * K5_KHALF, kt + slots * K5_LD + khalf * K5_KHALF, lane);
    float* sp = sc + khalf * K5_HEADS * K5_TILE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = slots + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(sp + g * K5_TILE + col) = make_float2(c[j][0], c[j][1]);
      *reinterpret_cast<float2*>(sp + (g + 8) * K5_TILE + col) = make_float2(c[j][2], c[j][3]);
    }
    __syncthreads();

    // the tile's 32 logits of heads g and g + 8, in the C-fragment layout of 4 n8 tiles
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), col = j * 8 + 2 * t4 + (e & 1);
        const float x = sc[row * K5_TILE + col] + sc[(K5_HEADS + row) * K5_TILE + col];
        s[j][e] = t0 + col < hi ? x : NEG_INF;
      }
    }
    // online softmax, as flash_mma.cuh's: m on the raw logits, p = 2^(s sl2 - m sl2)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float ref = is_live(m_new) ? m_new * sl2 : 0.f;
      const float alpha = fast_exp2((m[h] - m_new) * sl2);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][2 * h] = fast_exp2(fmaf(s[j][2 * h], sl2, -ref));
        s[j][2 * h + 1] = fast_exp2(fmaf(s[j][2 * h + 1], sl2, -ref));
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int j = 0; j < K5_DW / 8; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }
    unsigned pa[2][4];
    mma_c_to_a<2>(pa, s);
    mma_rows_pv<K5_DW / 8, 2, K5_LD>(o, pa, kt + warp * K5_DW, lane);
  }
  cp_async_wait<0>();  // no copy outlives the block

  const SplitPartials P = split_partials(part, gridDim.x, gridDim.y, K5_HEADS, K5_DV);
  const long long row = ((long long)b * gridDim.y + split) * K5_HEADS;  // head h of this split: row + h
#pragma unroll
  for (int j = 0; j < K5_DW / 8; ++j) {
    const int d = warp * K5_DW + j * 8 + 2 * t4;
    *reinterpret_cast<float2*>(P.acc + (row + g) * K5_DV + d) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(P.acc + (row + g + 8) * K5_DV + d) = make_float2(o[j][2], o[j][3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (warp == 0 && t4 == 0) {  // every warp holds the same m and l
    P.m[row + g] = m[0] * scale;  // the merge's m is of the scaled logits, natural log
    P.l[row + g] = l[0];
    P.m[row + g + 8] = m[1] * scale;
    P.l[row + g + 8] = l[1];
  }
}

}  // namespace zt

// q (B, 16, 576) bf16 with unit stride on the last dim, rows 16-byte aligned; kv the
// cache (B, 1, T, 576) bf16 read through kv_sb (row) and kv_st (slot), both in
// elements, unit stride on the last dim, 16-byte aligned; kv_len (B,) int32 clipped to
// [0, T]; part the fp32 split scratch of B * nsplit * 16 * (512 + 2) values, 16-byte
// aligned; out a contiguous (B, 16, 512) bf16 tensor. Launches the split pass over
// B x nsplit blocks of split_len slots (a multiple of K5_TILE), then the split merge.
extern "C" int zt_flash_mla_decode(const void* q, const void* kv, const int* kv_len, void* part, void* out,
                                   int B, int T, int split_len, int nsplit, long long q_sb, long long q_sh,
                                   long long kv_sb, long long kv_st, float scale, void* stream) {
  using namespace zt;
  cudaGetLastError();
  if (B <= 0 || T <= 0 || split_len <= 0 || split_len % K5_TILE != 0 || nsplit != (T + split_len - 1) / split_len)
    return ZT_UNSUPPORTED;
  static const cudaError_t allowed =
      cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K5_SMEM);  // once
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  mla_decode_kernel<<<dim3(B, nsplit), K5_THREADS, K5_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv), kv_len, pt, T, split_len, q_sb,
      q_sh, kv_sb, kv_st, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_split_merge(pt, kv_len, 1, 1, 0, split_len, nsplit, out, BF16, B, K5_HEADS, K5_DV, st);
}
