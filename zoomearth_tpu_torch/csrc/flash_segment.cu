// K1: packed varlen (segment-id) self-attention for the ViT, hand-written for Hopper.
//
// Replaces zoomearth_tpu/ops/flash_attention.py::flash_segment_attention (Pallas,
// pallas_call at :156, body _kernel at :29).
//
// Semantics: row s attends to the rows t with seg[t] == seg[s]; segment ids ascend,
// pad rows share the id PAD_SEG and attend among themselves.
//
// What bounds it on the card: operations. At the ViT's full-attention blocks every
// 512 px image is one 1296-token segment, so a tile of query rows does ~1296 x D x 4
// flops per row against 2 x 1296 x D x 2 bytes of k/v per head: far above the H100's
// ~295 flops/byte bf16 balance point once a k/v tile is reused by 128 rows, and the
// rate for such products is in the tensor cores. As measured with the products on
// the tensor cores, the tile copies from L2 and the softmax share the bound
// (flash_mma.cuh says how that was found).
//
// What the design does about it (bf16, D a multiple of 16: the model's path, D = 80):
// the tensor-core flash core of flash_mma.cuh (wgmma at D = 80 and 128, mma.sync at
// the smaller head dims; a ring of three stages of cp.async copies; two blocks an SM
// up to D = 80). A block owns 128 consecutive rows of
// one head and walks only the contiguous key range [kv_first, kv_last) of the
// segments its rows belong to (two searchsorteds in the wrapper). The segment
// compare runs only on tiles that need it: a tile whose keys all carry the one id
// of a single-segment block skips it, so a 1296-row image masks at its two ends only;
// with segments of 16-64 rows (the windowed blocks when they take this kernel) every
// tile is masked and most of each product is discarded, as in the TPU kernel. D = 80
// is handled as is: 5 k-steps for Q K^T, 10 n-tiles for P V, rows padded to 88
// elements in shared memory. q/k/v are read through their strides (16-byte aligned):
// the ViT passes views of the fused qkv projection.
//
// fp32 inputs (the tiny config's parity runs) and head dims that are no multiple of
// 16 keep the first version below: plain fp32 FMA over an fp32 tile of 32 keys, 64
// rows a block. zt_flash_segment_variant says which of the two a dtype and head dim
// get; the wrapper computes the key ranges for that block size.
#include "flash_policy.cuh"

namespace zt {

// ---------------------------------------------------------------------------
// The fp32 variant: a block owns 64 rows of one head; each row's D dims are spread
// over 4 threads; online softmax in fp32 over fp32 tiles.
// ---------------------------------------------------------------------------
constexpr int SEG_ROWS = 64;  // query rows per block
constexpr int SEG_TPR = 4;    // threads per query row
constexpr int SEG_BKV = 32;   // kv rows per shared-memory tile

template <int D, typename T>
__global__ void __launch_bounds__(SEG_ROWS* SEG_TPR)
    flash_segment_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const int* __restrict__ seg, const int* __restrict__ kv_first,
                         const int* __restrict__ kv_last, T* __restrict__ out, float* __restrict__ lse,
                         int S, long long q_ss, long long q_sh, long long k_ss, long long k_sh,
                         long long v_ss, long long v_sh, float scale) {
  constexpr int DPT = D / SEG_TPR;
  __shared__ float k_t[SEG_BKV * D];
  __shared__ float v_t[SEG_BKV * D];
  __shared__ int seg_t[SEG_BKV];

  const int tid = threadIdx.x;
  const int row = tid / SEG_TPR;
  const int j = tid % SEG_TPR;
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int s = qb * SEG_ROWS + row;
  const bool active = s < S;

  float qr[DPT], acc[DPT];
  int seg_q = -1;  // real segment ids are >= 0: an inactive row matches nothing
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = 0.f;
    acc[i] = 0.f;
  }
  if (active) {
    const T* qp = q + (long long)s * q_ss + (long long)h * q_sh;
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = to_f(qp[i * SEG_TPR + j]) * scale;
    seg_q = seg[s];
  }
  float m = NEG_INF, l = 0.f;

  const int first = kv_first[qb];
  const int last = kv_last[qb];
  for (int t0 = first; t0 < last; t0 += SEG_BKV) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < SEG_BKV * D; idx += blockDim.x) {
      const int t = idx / D;
      const int d = idx - t * D;
      const long long ta = t0 + t;
      float kx = 0.f, vx = 0.f;
      if (ta < last) {
        kx = to_f(k[ta * k_ss + (long long)h * k_sh + d]);
        vx = to_f(v[ta * v_ss + (long long)h * v_sh + d]);
      }
      k_t[idx] = kx;
      v_t[idx] = vx;
    }
    if (tid < SEG_BKV) seg_t[tid] = (t0 + tid < last) ? seg[t0 + tid] : -2;
    __syncthreads();

    float sc[SEG_BKV];
#pragma unroll
    for (int t = 0; t < SEG_BKV; ++t) {
      const float* kr = k_t + t * D + j;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qr[i], kr[i * SEG_TPR], part);
      part = group4_sum(part);
      sc[t] = (seg_t[t] == seg_q) ? part : NEG_INF;
    }
    softmax_tile<DPT, SEG_TPR, SEG_BKV>(sc, v_t, D, nullptr, j, m, l, acc);
  }

  if (active) {
    T* op = out + ((long long)s * gridDim.y + h) * D;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * SEG_TPR + j] = from_f<T>(acc[i] * inv);
    // q was scaled, so m and the p's are of the scaled logits already; no live key: NEG_INF
    if (lse != nullptr && j == 0) lse[(long long)s * gridDim.y + h] = l > 0.f ? m + logf(l) : NEG_INF;
  }
}

template <int D, typename T>
static int launch_segment(const void* q, const void* k, const void* v, const int* seg,
                          const int* kv_first, const int* kv_last, void* out, float* lse, int S, int H,
                          long long q_ss, long long q_sh, long long k_ss, long long k_sh,
                          long long v_ss, long long v_sh, float scale, cudaStream_t stream) {
  const dim3 grid((S + SEG_ROWS - 1) / SEG_ROWS, H);
  flash_segment_kernel<D, T><<<grid, SEG_ROWS * SEG_TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg, kv_first,
      kv_last, static_cast<T*>(out), lse, S, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core variant: flash_mma.cuh's core under SegmentPolicy (flash_policy.cuh).
// ---------------------------------------------------------------------------
// Two blocks an SM up to D = 80 (128 registers a thread: one block's products and
// copies then fill the other's softmax and barrier waits), one at D = 128.
template <int D>
__global__ void __launch_bounds__(FM_THREADS, D <= 80 ? 2 : 1)
    flash_segment_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                             const int* __restrict__ kv_first, const int* __restrict__ kv_last,
                             __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, long long q_ss,
                             long long q_sh, long long k_ss, long long k_sh, long long v_ss, long long v_sh,
                             float scale) {
  extern __shared__ __align__(16) unsigned char fm_smem[];
  SegmentPolicy pol;
  pol.init(q, k, v, seg, kv_first, kv_last, S, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh);
  const int h = blockIdx.y;
  pol.D = D;
  pol.ob = out + (long long)h * D;
  pol.lseb = lse != nullptr ? lse + h : nullptr;
  flash_mma_block<D, __nv_bfloat16>(pol, fm_smem, scale * LOG2E);
}

template <int D>
static int launch_segment_mma(const void* q, const void* k, const void* v, const int* seg,
                              const int* kv_first, const int* kv_last, void* out, float* lse, int S, int H,
                              long long q_ss, long long q_sh, long long k_ss, long long k_sh,
                              long long v_ss, long long v_sh, float scale, cudaStream_t stream) {
  constexpr int smem = fm_smem_bytes<D, false>();
  static const int allowed = fm_allow_smem(flash_segment_mma_kernel<D>, smem);  // once
  if (allowed != 0) return allowed;
  const dim3 grid((S + FM_ROWS - 1) / FM_ROWS, H);
  flash_segment_mma_kernel<D><<<grid, FM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg, kv_first, kv_last, static_cast<__nv_bfloat16*>(out), lse, S,
      q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace zt

// Query rows per block of the variant a dtype and head dim get: FM_ROWS (the
// tensor-core variant: bf16, D a multiple of 16), SEG_ROWS (fp32 FMA) or
// ZT_UNSUPPORTED. kv_first / kv_last are per block of that many rows.
extern "C" int zt_flash_segment_variant(int dtype, int D) {
  using namespace zt;
  if (D != 8 && D != 16 && D != 32 && D != 64 && D != 80 && D != 128) return ZT_UNSUPPORTED;
  if (dtype == BF16) return D % 16 == 0 ? FM_ROWS : SEG_ROWS;
  if (dtype == F32) return SEG_ROWS;
  return ZT_UNSUPPORTED;
}

// out must be a contiguous (S, H, D) tensor; q/k/v are (S, H, D) with unit stride on D;
// kv_first / kv_last hold one key range per block of zt_flash_segment_variant rows.
// The tensor-core variant copies 16-byte vectors: q/k/v bases and strides must be
// whole 16-byte multiples (the wrapper checks). lse, when not null, is an (S, H) fp32
// tensor that gets each row's log-sum-exp of the scaled logits (the backward's input;
// NEG_INF for a row with no live key).
extern "C" int zt_flash_segment(const void* q, const void* k, const void* v, const int* seg,
                                const int* kv_first, const int* kv_last, void* out, int S, int H,
                                int D, long long q_ss, long long q_sh, long long k_ss,
                                long long k_sh, long long v_ss, long long v_sh, float scale,
                                int dtype, void* stream, float* lse) {
  using namespace zt;
  cudaGetLastError();  // clear any stale error so the return value is this launch's
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zt_flash_segment_variant(dtype, D) == FM_ROWS) {
#define ZT_SEG_MMA(DD)                                                                           \
  return launch_segment_mma<DD>(q, k, v, seg, kv_first, kv_last, out, lse, S, H, q_ss, q_sh, k_ss, k_sh, \
                                v_ss, v_sh, scale, st)
    switch (D) {
      case 16: ZT_SEG_MMA(16);
      case 32: ZT_SEG_MMA(32);
      case 64: ZT_SEG_MMA(64);
      case 80: ZT_SEG_MMA(80);
      case 128: ZT_SEG_MMA(128);
      default: return ZT_UNSUPPORTED;
    }
#undef ZT_SEG_MMA
  }
#define ZT_SEG(DD, TT)                                                                         \
  return launch_segment<DD, TT>(q, k, v, seg, kv_first, kv_last, out, lse, S, H, q_ss, q_sh, k_ss, \
                                k_sh, v_ss, v_sh, scale, st)
#define ZT_SEG_D(TT)      \
  switch (D) {            \
    case 8: ZT_SEG(8, TT);   \
    case 16: ZT_SEG(16, TT); \
    case 32: ZT_SEG(32, TT); \
    case 64: ZT_SEG(64, TT); \
    case 80: ZT_SEG(80, TT); \
    case 128: ZT_SEG(128, TT); \
    default: return ZT_UNSUPPORTED; \
  }
  if (dtype == F32) { ZT_SEG_D(float) }
  if (dtype == BF16 && D == 8) { ZT_SEG(8, __nv_bfloat16); }
#undef ZT_SEG_D
#undef ZT_SEG
  return ZT_UNSUPPORTED;
}

extern "C" const char* zt_error_string(int code) {
  if (code == zt::ZT_UNSUPPORTED) return "unsupported shape or dtype for this kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
