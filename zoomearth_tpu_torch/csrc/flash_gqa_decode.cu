// K6: single-token GQA decode at key width 192 and value width 128 for MiMo-V2.5's
// layers (models/hybrid.py), hand-written for Hopper. No TPU kernel computes this; the
// port adds it with the model. K3 stops at 8 query heads a KV head and one width for k
// and v; the global layers have 16 heads a KV head, and the window layers 8 with a
// window and a sink.
//
// Semantics: q (B, H, 192); k (B, Hkv, T, 192) and v (B, Hkv, T, 128), the cache or a
// prefix view of it, read through their strides in place. Row b attends to the slots
// [start, kv_len[b]) with start = max(kv_len[b] - window, 0) for window > 0, else 0:
// o_h = sum_t softmax_t(scale q_h . k_t) v_t, (B, H, 128). With sinks, each head's sink
// logit joins the softmax as one more column whose value is 0. A row with kv_len == 0
// reads nothing and gets 0.
//
// What bounds it on the card: bytes. Each slot's key and value rows (640 bytes a KV
// head) serve G = 8 or 16 heads with two products over 192 + 128 dims: 16 or 32 flop a
// byte, which fp32 FMA could not keep up with at 3.35 TB/s, so both products run on the
// tensor cores, with the G heads as the rows of mma.sync m16n8k16's A (8 heads padded
// to 16 with zero rows, which cost products and no bytes).
//
// What the design does about it: K5's core (flash_mla_decode.cu) with separate key and
// value streams.
// - The key axis of each (row, KV head) pair is split across blocks, the split length
//   chosen on the host from the shapes alone (ops/flash_gqa_decode.py::split_plan, over
//   min(T, window) for a window layer); splits count from the row's window start, and a
//   block whose split starts at or past kv_len exits at once, so reads scale with the
//   live slots of the window, not with T.
// - A block of four warps streams its split in tiles of K6_TILE = 32 slots through a
//   two-stage ring of cp.async copies (rows padded by 16 bytes for ldmatrix), q staged
//   once. Two blocks an SM.
// - Scores: warp w takes the tile's slots 16 (w % 2) .. + 15 over half of the 192 key
//   dims (w / 2) (flash_mma.cuh's mma_rows_abt); the halves meet in shared memory, and
//   every warp takes the same online-softmax step on the tile's 32 summed scores.
// - Values: warp w accumulates output dims 32 w .. + 31 of all heads (mma_rows_pv), P
//   straight from the softmax's registers.
// - The first split of a pair starts its softmax state at the sink (m at the sink's raw
//   logit, weight 1), so the merged result is the softmax with the sink column.
// - Each block leaves its state per head (m, l, acc[128]) in scratch, and the shared
//   split merge (split_merge.cu) combines the splits each pair walked: one C call, two
//   launches.
#include "flash_mma.cuh"

namespace zt {

constexpr int K6_M = 16;                       // rows of the products: a KV head's query heads, padded to 16
constexpr int K6_DK = 192;                     // key width
constexpr int K6_DV = 128;                     // value width
constexpr int K6_TILE = 32;                    // slots per staged tile
constexpr int K6_STAGES = 2;                   // ring depth: one tile in flight while one computes
constexpr int K6_WARPS = 4;
constexpr int K6_THREADS = 32 * K6_WARPS;
constexpr int K6_LDK = K6_DK + 8;              // padded key row, elements (400 bytes: 16 apart mod 128)
constexpr int K6_LDV = K6_DV + 8;              // padded value row (272 bytes)
constexpr int K6_KVEC = K6_DK / 8;             // 16-byte vectors per key row
constexpr int K6_VVEC = K6_DV / 8;
constexpr int K6_KHALF = K6_DK / 2;            // key dims of one warp's score product
constexpr int K6_DW = K6_DV / K6_WARPS;        // output dims of one warp
constexpr int K6_SMEM = 2 * (K6_M * K6_LDK + K6_STAGES * K6_TILE * (K6_LDK + K6_LDV)) + 4 * 2 * K6_M * K6_TILE;

// Grid (B * Hkv, nsplit): block (pair, split), pair = b * Hkv + kv head. kv_len (B,)
// int32 clipped to [0, T]; sink (H,) fp32 or nullptr; part the split scratch
// (SplitPartials, pairs = B * Hkv, G heads, D = 128).
template <int G>
__global__ void __launch_bounds__(K6_THREADS, 2)
    gqa_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
                      const float* __restrict__ sink, float* __restrict__ part, int Hkv, int split_len,
                      long long q_sb, long long q_sh, long long k_sb, long long k_sh, long long k_st, long long v_sb,
                      long long v_sh, long long v_st, float scale, int window) {
  static_assert(G == 8 || G == 16, "one m16 tile of heads");
  const int pair = blockIdx.x, split = blockIdx.y;
  const int b = pair / Hkv, kh = pair % Hkv;
  const int klen = kv_len[b];
  const int start = window > 0 ? max(klen - window, 0) : 0;
  const int lo = start + split * split_len;
  if (lo >= klen) return;  // past the row's live slots (or none live): the merge never reads this split
  const int hi = min(lo + split_len, klen);
  const int ntiles = (hi - lo + K6_TILE - 1) / K6_TILE;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ktiles = qs + K6_M * K6_LDK;
  __nv_bfloat16* vtiles = ktiles + K6_STAGES * K6_TILE * K6_LDK;
  float* sc = reinterpret_cast<float*>(vtiles + K6_STAGES * K6_TILE * K6_LDV);  // [key half][head][slot]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)kh * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)kh * v_sh;

  // tile i into stage i % K6_STAGES, rows past hi zero-filled; one group per call
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      const int st = i % K6_STAGES;
      __nv_bfloat16* kd = ktiles + st * K6_TILE * K6_LDK;
      __nv_bfloat16* vd = vtiles + st * K6_TILE * K6_LDV;
      const int t0 = lo + i * K6_TILE;
      for (int e = tid; e < K6_TILE * K6_KVEC; e += K6_THREADS) {
        const int row = e / K6_KVEC, vec = e % K6_KVEC;
        const bool ok = t0 + row < hi;
        cp_async16_z<false>(kd + row * K6_LDK + vec * 8, kb + (long long)(ok ? t0 + row : lo) * k_st + vec * 8, ok);
      }
      for (int e = tid; e < K6_TILE * K6_VVEC; e += K6_THREADS) {
        const int row = e / K6_VVEC, vec = e % K6_VVEC;
        const bool ok = t0 + row < hi;
        cp_async16_z<false>(vd + row * K6_LDV + vec * 8, vb + (long long)(ok ? t0 + row : lo) * v_st + vec * 8, ok);
      }
    }
    cp_async_commit();
  };

  // the pair's G query heads ride with tile 0's group; rows G .. 15 are zeros
  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)kh * G * q_sh;
  for (int e = tid; e < K6_M * K6_KVEC; e += K6_THREADS) {
    const int h = e / K6_KVEC, vec = e % K6_KVEC;
    cp_async16_z<false>(qs + h * K6_LDK + vec * 8, qb + (long long)(h < G ? h : 0) * q_sh + vec * 8, h < G);
  }
#pragma unroll
  for (int i = 0; i < K6_STAGES - 1; ++i) load_tile(i);

  const int slots = (warp & 1) * 16;  // this warp's slots of the score product
  const int khalf = warp >> 1;        // and its half of the key dims
  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF};  // running max of the raw logits, heads g and g + 8
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  if (split == 0 && sink != nullptr) {  // the sink column, once per pair
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (g + 8 * h < G) {
        m[h] = sink[kh * G + g + 8 * h] / scale;
        l[h] = t4 == 0 ? 1.f : 0.f;
      }
    }
  }
  float o[K6_DW / 8][4];
#pragma unroll
  for (int j = 0; j < K6_DW / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<K6_STAGES - 2>();
    __syncthreads();  // tile i has arrived; tile i - 1's stage and the scores are consumed
    load_tile(i + K6_STAGES - 1);
    const int st = i % K6_STAGES;
    const __nv_bfloat16* kt = ktiles + st * K6_TILE * K6_LDK;
    const __nv_bfloat16* vt = vtiles + st * K6_TILE * K6_LDV;
    const int t0 = lo + i * K6_TILE;

    float c[2][4];
    mma_rows_abt<K6_KHALF, 2, K6_LDK>(c, qs + khalf * K6_KHALF, kt + slots * K6_LDK + khalf * K6_KHALF, lane);
    float* sp = sc + khalf * K6_M * K6_TILE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = slots + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(sp + g * K6_TILE + col) = make_float2(c[j][0], c[j][1]);
      *reinterpret_cast<float2*>(sp + (g + 8) * K6_TILE + col) = make_float2(c[j][2], c[j][3]);
    }
    __syncthreads();

    // the tile's 32 logits of heads g and g + 8, in the C-fragment layout of 4 n8 tiles
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), col = j * 8 + 2 * t4 + (e & 1);
        const float x = sc[row * K6_TILE + col] + sc[(K6_M + row) * K6_TILE + col];
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
      for (int j = 0; j < K6_DW / 8; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }
    unsigned pa[2][4];
    mma_c_to_a<2>(pa, s);
    mma_rows_pv<K6_DW / 8, 2, K6_LDV>(o, pa, vt + warp * K6_DW, lane);
  }
  cp_async_wait<0>();  // no copy outlives the block

  const SplitPartials P = split_partials(part, gridDim.x, gridDim.y, G, K6_DV);
  const long long row = ((long long)pair * gridDim.y + split) * G;  // head h of this split: row + h
#pragma unroll
  for (int j = 0; j < K6_DW / 8; ++j) {
    const int d = warp * K6_DW + j * 8 + 2 * t4;
    *reinterpret_cast<float2*>(P.acc + (row + g) * K6_DV + d) = make_float2(o[j][0], o[j][1]);
    if (g + 8 < G) *reinterpret_cast<float2*>(P.acc + (row + g + 8) * K6_DV + d) = make_float2(o[j][2], o[j][3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (warp == 0 && t4 == 0) {  // every warp holds the same m and l
    P.m[row + g] = m[0] * scale;  // the merge's m is of the scaled logits, natural log
    P.l[row + g] = l[0];
    if (g + 8 < G) {
      P.m[row + g + 8] = m[1] * scale;
      P.l[row + g + 8] = l[1];
    }
  }
}

template <int G>
static int launch_gqa_decode(const void* q, const void* k, const void* v, const int* kv_len, const int* walk,
                             const float* sink, float* part, void* out, int B, int Hkv, int split_len, int nsplit,
                             long long q_sb, long long q_sh, long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st, float scale, int window,
                             cudaStream_t st) {
  static const cudaError_t allowed =
      cudaFuncSetAttribute(gqa_decode_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, K6_SMEM);  // once
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  gqa_decode_kernel<G><<<dim3(B * Hkv, nsplit), K6_THREADS, K6_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len, sink, part, Hkv, split_len, q_sb, q_sh, k_sb, k_sh, k_st, v_sb,
      v_sh, v_st, scale, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_split_merge(part, walk, Hkv, 1, 0, split_len, nsplit, out, BF16, B * Hkv, G, K6_DV, st);
}

}  // namespace zt

// q (B, H, 192) bf16 with unit stride on the last dim, rows 16-byte aligned; k (B, Hkv,
// T, 192) and v (B, Hkv, T, 128) bf16 read through their row, head and slot strides (in
// elements), unit stride on the last dim, 16-byte aligned; G = H / Hkv is 8 or 16;
// kv_len (B,) int32 clipped to [0, T]; walk (B,) int32 the slots each row attends to,
// min(kv_len, window) for window > 0, else kv_len; sink (H,) fp32 or null; part the fp32
// split scratch of B * Hkv * nsplit * G * (128 + 2) values, 16-byte aligned; out a
// contiguous (B, H, 128) bf16 tensor. Launches the split pass over (B * Hkv) x nsplit
// blocks of split_len slots (a multiple of K6_TILE) counted from each row's window
// start, then the split merge.
extern "C" int zt_flash_gqa_decode(const void* q, const void* k, const void* v, const int* kv_len, const int* walk,
                                   const float* sink, void* part, void* out, int B, int Hkv, int T, int G,
                                   int split_len, int nsplit, long long q_sb, long long q_sh, long long k_sb,
                                   long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
                                   float scale, int window, void* stream) {
  using namespace zt;
  cudaGetLastError();
  const int span = window > 0 ? min(T, window) : T;
  if (B <= 0 || Hkv <= 0 || T <= 0 || split_len <= 0 || split_len % K6_TILE != 0 ||
      nsplit != (span + split_len - 1) / split_len)
    return ZT_UNSUPPORTED;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  if (G == 8)
    return launch_gqa_decode<8>(q, k, v, kv_len, walk, sink, pt, out, B, Hkv, split_len, nsplit, q_sb, q_sh, k_sb,
                                k_sh, k_st, v_sb, v_sh, v_st, scale, window, st);
  if (G == 16)
    return launch_gqa_decode<16>(q, k, v, kv_len, walk, sink, pt, out, B, Hkv, split_len, nsplit, q_sb, q_sh, k_sb,
                                 k_sh, k_st, v_sb, v_sh, v_st, scale, window, st);
  return ZT_UNSUPPORTED;
}
