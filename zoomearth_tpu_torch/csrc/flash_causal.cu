// K2: causal GQA attention for prefill and chunk prefill, hand-written for Hopper.
//
// Replaces zoomearth_tpu/ops/flash_causal.py::flash_causal_attention (Pallas,
// pallas_call at :208, body _kernel at :28).
//
// Semantics: the query at positions[b, s] sees kv slots t <= positions[b, s] and
// t < kv_len[b] (slot order == position order in the cache). With int8 K/V the
// per-token scales ks multiply the logit columns and vs multiplies p before p@v:
// exact algebra w.r.t. the quantized values, as the TPU kernel computes it. A row
// with no live slot returns 0.
//
// What bounds it on the card: by count, operations (22 GFLOP against 34 MB at the
// chunk prefill's shapes). The G = 8 query heads of one kv head read the same k/v
// rows, so every k/v byte feeds 8 x (block positions) rows of dot products: the work
// is two matrix products per tile, and the card's rate for those is in its tensor
// cores. As measured with the products on the tensor cores, the tile copies from L2
// bound it (flash_mma.cuh says how that was found).
//
// What the design does about it (bf16 queries, the model's path): the tensor-core
// flash core of flash_mma.cuh (wgmma at D = 128, mma.sync at the smaller head dims;
// a ring of three stages of cp.async copies). A block owns (b, kv head, 128 / G query positions) and
// folds the G query heads into its 128 rows (row r is head r / bq, position r % bq,
// bq = 128 / G), so one bf16 k/v tile in shared memory serves all G heads. The key
// loop stops at the block's largest position + 1 (clipped by kv_len), so tiles above
// the causal diagonal and past the live length are never read, and the causal/length
// compare runs only on tiles that reach past the block's smallest position (or past
// kv_len): positions are per row, ragged across the batch and in no order for pad
// rows, so the mask reads each row's own position. q, k and v are read through their
// strides (16-byte aligned): the cache's (B, Hkv, T, D) layout, its prefix views and
// the fresh projections' transposed views need no copy.
//
// fp32 queries (the tiny config's parity runs) keep the first version below: plain
// fp32 FMA over an fp32 tile of 32 keys, 64 rows a block. bf16 tensor-core products
// would cost them the precision they are run for. zt_flash_causal_variant says which
// of the two a dtype and head dim get.
#include "flash_policy.cuh"

namespace zt {

// ---------------------------------------------------------------------------
// The fp32 variant: a block owns (b, kv head, 64 / G query positions); each row's D
// dims are spread over 4 threads; online softmax in fp32 over fp32 tiles.
// ---------------------------------------------------------------------------
constexpr int CAU_ROWS = 64;  // (head, query) rows per block
constexpr int CAU_TPR = 4;    // threads per row
constexpr int CAU_BKV = 32;   // kv rows per shared-memory tile

template <int D, typename QT, typename KT>
__global__ void __launch_bounds__(CAU_ROWS* CAU_TPR)
    flash_causal_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v, const float* __restrict__ ksc,
                        const float* __restrict__ vsc, const int* __restrict__ positions,
                        const int* __restrict__ kv_len, QT* __restrict__ out, float* __restrict__ lse,
                        int S, int T, int G, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                        long long k_sh, long long k_st, long long v_sb, long long v_sh,
                        long long v_st, long long sc_sb, long long sc_sh, float scale) {
  constexpr int DPT = D / CAU_TPR;
  constexpr bool QUANT = sizeof(KT) == 1;
  __shared__ float k_t[CAU_BKV * D];
  __shared__ float v_t[CAU_BKV * D];
  __shared__ float ks_t[CAU_BKV];
  __shared__ float vs_t[CAU_BKV];
  __shared__ int hi_s;

  const int tid = threadIdx.x;
  const int row = tid / CAU_TPR;
  const int j = tid % CAU_TPR;
  const int bq = CAU_ROWS / G;  // query positions per block
  const int g = row / bq;
  const int s = blockIdx.x * bq + row % bq;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int h = kh * G + g;
  const bool active = s < S;
  const int klen = min(max(kv_len[b], 0), T);

  int pos = -1;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = 0.f;
    acc[i] = 0.f;
  }
  if (active) {
    pos = positions[(long long)b * S + s];
    const QT* qp = q + (long long)b * q_sb + (long long)s * q_ss + (long long)h * q_sh;
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = to_f(qp[i * CAU_TPR + j]) * scale;
  }
  if (tid == 0) hi_s = 0;
  __syncthreads();
  if (active && j == 0 && g == 0) atomicMax(&hi_s, min(pos + 1, klen));
  __syncthreads();
  const int hi = hi_s;  // causal bound of this block, clipped by kv_len

  const KT* kb = k + (long long)b * k_sb + (long long)kh * k_sh;
  const KT* vb = v + (long long)b * v_sb + (long long)kh * v_sh;
  float m = NEG_INF, l = 0.f;
  for (int t0 = 0; t0 < hi; t0 += CAU_BKV) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < CAU_BKV * D; idx += blockDim.x) {
      const int t = idx / D;
      const int d = idx - t * D;
      const long long ta = t0 + t;
      float kx = 0.f, vx = 0.f;
      if (ta < hi) {
        kx = to_f(kb[ta * k_st + d]);
        vx = to_f(vb[ta * v_st + d]);
      }
      k_t[idx] = kx;
      v_t[idx] = vx;
    }
    if (QUANT && tid < CAU_BKV) {
      const int ta = t0 + tid;
      const long long o = (long long)b * sc_sb + (long long)kh * sc_sh + ta;
      ks_t[tid] = ta < hi ? ksc[o] : 0.f;
      vs_t[tid] = ta < hi ? vsc[o] : 0.f;
    }
    __syncthreads();

    float sc[CAU_BKV];
#pragma unroll
    for (int t = 0; t < CAU_BKV; ++t) {
      const float* kr = k_t + t * D + j;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qr[i], kr[i * CAU_TPR], part);
      part = group4_sum(part);
      if (QUANT) part *= ks_t[t];
      const int ta = t0 + t;
      sc[t] = (ta <= pos && ta < klen) ? part : NEG_INF;
    }
    softmax_tile<DPT, CAU_TPR, CAU_BKV>(sc, v_t, D, QUANT ? vs_t : nullptr, j, m, l, acc);
  }

  if (active) {
    const int H = gridDim.y * G;
    QT* op = out + (((long long)b * S + s) * H + h) * D;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * CAU_TPR + j] = from_f<QT>(acc[i] * inv);
    // q was scaled, so m and the p's are of the scaled logits already; no live key: NEG_INF
    if (lse != nullptr && j == 0) lse[((long long)b * S + s) * H + h] = l > 0.f ? m + logf(l) : NEG_INF;
  }
}

template <int D, typename QT, typename KT>
static int launch_causal(const void* q, const void* k, const void* v, const float* ksc,
                         const float* vsc, const int* positions, const int* kv_len, void* out,
                         float* lse, int B, int S, int Hkv, int T, int G, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_sh, long long k_st,
                         long long v_sb, long long v_sh, long long v_st, long long sc_sb,
                         long long sc_sh, float scale, cudaStream_t stream) {
  const int bq = CAU_ROWS / G;
  const dim3 grid((S + bq - 1) / bq, Hkv, B);
  flash_causal_kernel<D, QT, KT><<<grid, CAU_ROWS * CAU_TPR, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), ksc, vsc,
      positions, kv_len, static_cast<QT*>(out), lse, S, T, G, q_sb, q_ss, q_sh, k_sb, k_sh, k_st, v_sb,
      v_sh, v_st, sc_sb, sc_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core variant: flash_mma.cuh's core under CausalPolicy (flash_policy.cuh).
// ---------------------------------------------------------------------------
// One block an SM at D = 128 (its 166 registers a thread spill at the 128 that two
// blocks would allow, and ran slower), two up to D = 64.
template <int D, typename KT>
__global__ void __launch_bounds__(FM_THREADS, D <= 64 ? 2 : 1)
    flash_causal_mma_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
                            const KT* __restrict__ v, const float* __restrict__ ksc,
                            const float* __restrict__ vsc, const int* __restrict__ positions,
                            const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int S, int T, int G, long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_sh, long long k_st, long long v_sb,
                            long long v_sh, long long v_st, long long sc_sb, long long sc_sh,
                            float scale) {
  extern __shared__ __align__(16) unsigned char fm_smem[];
  __shared__ int pos_s[FM_ROWS];
  CausalPolicy<KT> pol;
  pol.init(blockIdx.x, q, k, v, positions, kv_len, pos_s, S, T, G, q_sb, q_ss, q_sh, k_sb, k_sh, k_st, v_sb, v_sh,
           v_st);
  const int kh = blockIdx.y, b = blockIdx.z;
  pol.D = D;
  pol.ksb = ksc != nullptr ? ksc + (long long)b * sc_sb + (long long)kh * sc_sh : nullptr;
  pol.vsb = vsc != nullptr ? vsc + (long long)b * sc_sb + (long long)kh * sc_sh : nullptr;
  pol.ob = out + ((long long)b * S * pol.H + (long long)kh * G) * D;
  pol.lseb = lse != nullptr ? lse + (long long)b * S * pol.H + (long long)kh * G : nullptr;
  flash_mma_block<D, KT>(pol, fm_smem, scale * LOG2E);
}

template <int D, typename KT>
static int launch_causal_mma(const void* q, const void* k, const void* v, const float* ksc,
                             const float* vsc, const int* positions, const int* kv_len, void* out,
                             float* lse, int B, int S, int Hkv, int T, int G, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st, long long sc_sb,
                             long long sc_sh, float scale, cudaStream_t stream) {
  constexpr int smem = fm_smem_bytes<D, sizeof(KT) == 1>();
  static const int allowed = fm_allow_smem(flash_causal_mma_kernel<D, KT>, smem);  // once
  if (allowed != 0) return allowed;
  const int bq = FM_ROWS / G;
  const dim3 grid((S + bq - 1) / bq, Hkv, B);
  flash_causal_mma_kernel<D, KT><<<grid, FM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      ksc, vsc, positions, kv_len, static_cast<__nv_bfloat16*>(out), lse, S, T, G, q_sb, q_ss, q_sh, k_sb,
      k_sh, k_st, v_sb, v_sh, v_st, sc_sb, sc_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Latent attention's expanded form (models/mla.py): bf16 keys of width D = 192 against
// values of width DV = 128, the same core with the value tile and the output DV wide
// (mma.sync: wgmma takes one width for both here). Every query head has its own
// keys (H == Hkv, G == 1). One block an SM: its shared memory (181 KB) takes most of one.
// ---------------------------------------------------------------------------
template <int D, int DV>
__global__ void __launch_bounds__(FM_THREADS, 1)
    flash_causal_mla_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const int* __restrict__ positions,
                            const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out, int S, int T, int G,
                            long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_sh,
                            long long k_st, long long v_sb, long long v_sh, long long v_st, float scale) {
  extern __shared__ __align__(16) unsigned char fm_smem[];
  __shared__ int pos_s[FM_ROWS];
  CausalPolicy<__nv_bfloat16> pol;
  pol.init(blockIdx.x, q, k, v, positions, kv_len, pos_s, S, T, G, q_sb, q_ss, q_sh, k_sb, k_sh, k_st, v_sb, v_sh,
           v_st);
  const int kh = blockIdx.y, b = blockIdx.z;
  pol.D = DV;  // the output's row width
  pol.ksb = pol.vsb = nullptr;
  pol.ob = out + ((long long)b * S * pol.H + (long long)kh * G) * DV;
  pol.lseb = nullptr;
  flash_mma_block<D, __nv_bfloat16, CausalPolicy<__nv_bfloat16>, DV>(pol, fm_smem, scale * LOG2E);
}

// ---------------------------------------------------------------------------
// MiMo-V2.5's window layers (models/hybrid.py): the same 192 / 128 core under
// BandPolicy (flash_policy.cuh), each query seeing the `window` keys up to its own
// position and a sink logit per head. A block walks only the keys from its smallest
// position's window edge to its largest position, so a prefill row reads ~window + bq
// keys, not its whole prefix; the sink enters as the softmax state before the first
// key (flash_mma.cuh), which is the published softmax with one more column.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(FM_THREADS, 1)
    flash_causal_band_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const int* __restrict__ positions,
                             const int* __restrict__ kv_len, const float* __restrict__ sink,
                             __nv_bfloat16* __restrict__ out, int S, int T, int G, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_sh, long long k_st, long long v_sb,
                             long long v_sh, long long v_st, float scale, int window) {
  extern __shared__ __align__(16) unsigned char fm_smem[];
  __shared__ int pos_s[FM_ROWS];
  BandPolicy pol;
  pol.init(blockIdx.x, q, k, v, positions, kv_len, pos_s, S, T, G, q_sb, q_ss, q_sh, k_sb, k_sh, k_st, v_sb, v_sh,
           v_st);
  pol.init_band(window, sink, G, T, scale);
  const int kh = blockIdx.y, b = blockIdx.z;
  pol.D = 128;  // the output's row width
  pol.ksb = pol.vsb = nullptr;
  pol.ob = out + ((long long)b * S * pol.H + (long long)kh * G) * 128;
  pol.lseb = nullptr;
  flash_mma_block<192, __nv_bfloat16, BandPolicy, 128>(pol, fm_smem, scale * LOG2E);
}

}  // namespace zt

// K2 for MiMo-V2.5's window layers: as zt_flash_causal_mla (q (B, S, H, 192), k (B, Hkv,
// T, 192), v (B, Hkv, T, 128), bf16, the same strides and alignment, out a contiguous
// (B, S, H, 128) bf16 tensor), with window > 0: the query at positions[b, s] sees the
// slots t with positions[b, s] - window < t <= positions[b, s] and t < kv_len[b]; and
// sink, where not null, a contiguous (H,) fp32 tensor of each head's sink logit (in the
// scaled logits' units). No lse.
extern "C" int zt_flash_causal_band(const void* q, const void* k, const void* v, const int* positions,
                                    const int* kv_len, const float* sink, void* out, int B, int S, int H, int Hkv,
                                    int T, int D, int DV, int window, long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
                                    long long v_st, float scale, void* stream) {
  using namespace zt;
  cudaGetLastError();
  if (D != 192 || DV != 128 || window <= 0 || Hkv <= 0 || H % Hkv != 0 || FM_ROWS % (H / Hkv) != 0)
    return ZT_UNSUPPORTED;
  const int G = H / Hkv;
  constexpr int smem = fm_smem_bytes<192, false, 128>();
  static const int allowed = fm_allow_smem(flash_causal_band_kernel, smem);  // once
  if (allowed != 0) return allowed;
  const int bq = FM_ROWS / G;
  const dim3 grid((S + bq - 1) / bq, Hkv, B);
  flash_causal_band_kernel<<<grid, FM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), positions, kv_len, sink, static_cast<__nv_bfloat16*>(out), S, T, G, q_sb,
      q_ss, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale, window);
  return static_cast<int>(cudaGetLastError());
}

// K2 for latent attention's expanded form: q (B, S, H, 192), k (B, Hkv, T, 192) and
// v (B, Hkv, T, 128), bf16 with unit stride on the last dim, bases and strides whole
// 16-byte multiples; positions (B, S) and kv_len (B,) contiguous int32; out a
// contiguous (B, S, H, 128) bf16 tensor. G = H / Hkv divides FM_ROWS. No lse.
extern "C" int zt_flash_causal_mla(const void* q, const void* k, const void* v, const int* positions,
                                   const int* kv_len, void* out, int B, int S, int H, int Hkv, int T, int D,
                                   int DV, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                                   long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
                                   float scale, void* stream) {
  using namespace zt;
  cudaGetLastError();
  if (D != 192 || DV != 128 || Hkv <= 0 || H % Hkv != 0 || FM_ROWS % (H / Hkv) != 0) return ZT_UNSUPPORTED;
  const int G = H / Hkv;
  constexpr int smem = fm_smem_bytes<192, false, 128>();
  static const int allowed = fm_allow_smem(flash_causal_mla_kernel<192, 128>, smem);  // once
  if (allowed != 0) return allowed;
  const int bq = FM_ROWS / G;
  const dim3 grid((S + bq - 1) / bq, Hkv, B);
  flash_causal_mla_kernel<192, 128><<<grid, FM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), positions, kv_len, static_cast<__nv_bfloat16*>(out), S, T, G, q_sb, q_ss,
      q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale);
  return static_cast<int>(cudaGetLastError());
}

// Query rows per block of the variant these dtypes and head dim get: FM_ROWS (the
// tensor-core variant: bf16 q, bf16 or int8 k/v), CAU_ROWS (fp32 FMA: fp32 q) or
// ZT_UNSUPPORTED. G = H / Hkv must divide it.
extern "C" int zt_flash_causal_variant(int q_dtype, int kv_dtype, int D) {
  using namespace zt;
  if (D != 16 && D != 32 && D != 64 && D != 128) return ZT_UNSUPPORTED;
  if (q_dtype == BF16 && (kv_dtype == BF16 || kv_dtype == I8)) return FM_ROWS;
  if (q_dtype == F32 && (kv_dtype == F32 || kv_dtype == I8)) return CAU_ROWS;
  return ZT_UNSUPPORTED;
}

// q (B, S, H, D) and k/v (B, Hkv, T, D) with unit stride on D; positions (B, S) and
// kv_len (B,) contiguous int32; ksc/vsc (B, Hkv, T) fp32 with unit stride on T (int8
// K/V only, else null); out a contiguous (B, S, H, D) tensor. G = H / Hkv divides 64.
// lse, when not null, is a (B, S, H) fp32 tensor that gets each row's log-sum-exp of
// the scaled logits (the backward's input; NEG_INF for a row with no live key), last
// for the reason zt_flash_segment gives.
extern "C" int zt_flash_causal(const void* q, const void* k, const void* v, const float* ksc,
                               const float* vsc, const int* positions, const int* kv_len,
                               void* out, int B, int S, int H, int Hkv, int T, int D,
                               long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                               long long k_sh, long long k_st, long long v_sb, long long v_sh,
                               long long v_st, long long sc_sb, long long sc_sh, float scale,
                               int q_dtype, int kv_dtype, void* stream, float* lse) {
  using namespace zt;
  cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0) return ZT_UNSUPPORTED;
  const int G = H / Hkv;
  const int rows = zt_flash_causal_variant(q_dtype, kv_dtype, D);
  if (rows < 0 || G > rows || rows % G != 0) return ZT_UNSUPPORTED;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_CAU_MMA(DD, KK)                                                                        \
  return launch_causal_mma<DD, KK>(q, k, v, ksc, vsc, positions, kv_len, out, lse, B, S, Hkv, T, G, \
                                   q_sb, q_ss, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, sc_sb,  \
                                   sc_sh, scale, st)
#define ZT_CAU_MMA_D(KK)              \
  switch (D) {                        \
    case 16: ZT_CAU_MMA(16, KK);      \
    case 32: ZT_CAU_MMA(32, KK);      \
    case 64: ZT_CAU_MMA(64, KK);      \
    case 128: ZT_CAU_MMA(128, KK);    \
    default: return ZT_UNSUPPORTED;   \
  }
  if (q_dtype == BF16 && kv_dtype == BF16) { ZT_CAU_MMA_D(__nv_bfloat16) }
  if (q_dtype == BF16 && kv_dtype == I8) { ZT_CAU_MMA_D(int8_t) }
#undef ZT_CAU_MMA_D
#undef ZT_CAU_MMA
#define ZT_CAU(DD, QQ, KK)                                                                     \
  return launch_causal<DD, QQ, KK>(q, k, v, ksc, vsc, positions, kv_len, out, lse, B, S, Hkv, T, G, \
                                   q_sb, q_ss, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, sc_sb, \
                                   sc_sh, scale, st)
#define ZT_CAU_D(QQ, KK)             \
  switch (D) {                       \
    case 16: ZT_CAU(16, QQ, KK);     \
    case 32: ZT_CAU(32, QQ, KK);     \
    case 64: ZT_CAU(64, QQ, KK);     \
    case 128: ZT_CAU(128, QQ, KK);   \
    default: return ZT_UNSUPPORTED;  \
  }
  if (q_dtype == F32 && kv_dtype == F32) { ZT_CAU_D(float, float) }
  if (q_dtype == F32 && kv_dtype == I8) { ZT_CAU_D(float, int8_t) }
#undef ZT_CAU_D
#undef ZT_CAU
  return ZT_UNSUPPORTED;
}
