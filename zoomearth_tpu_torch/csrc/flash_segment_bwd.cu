// K1's backward: dq, dk and dv of packed varlen (segment-id) self-attention, for
// training the ViT, hand-written for Hopper.
//
// Replaces no TPU kernel: zoomearth_tpu/ops/flash_attention.py::flash_segment_attention
// has no VJP (flash_bwd.cuh says more). Row s sees the rows t with seg[t] == seg[s]
// (SegmentPolicy::rule, the forward's; ids ascending, pad rows sharing PAD_SEG and
// seeing each other), so the mask is symmetric: the query rows that see a block of
// keys are exactly the key range segment_kv_ranges gives that block as a block of
// queries, and one pair of range arrays (per block of ROWS rows) serves both kernels.
//
// The variants (bf16 at D a multiple of 16: the tensor-core "mma" kernels; fp32 and
// D = 8: the FMA ones), what bounds them and what the design does: flash_bwd.cuh. At
// the ViT's full-attention blocks a block of keys of one 5476-patch image walks all
// 5476 query rows; at the windowed blocks (segments of at most 64 rows) every block
// walks two or three windows, and each warp only the tiles its own rows or keys see.
#include "flash_bwd.cuh"

namespace zt {

template <typename T>
struct SegBwdArgs {
  const T* q;  // (S, H, D) through the strides below, unit stride on D
  const T* k;
  const T* v;
  const T* o;     // the forward's output, contiguous (S, H, D)
  const T* dout;  // its gradient, contiguous (S, H, D)
  const float* lse;  // (S, H), the forward's log-sum-exp of the scaled logits
  const int* seg;
  const int* first;  // per block of ROWS rows: the row range its segments cover
  const int* last;
  T* dq;  // contiguous (S, H, D)
  T* dk;
  T* dv;
  float* delta;  // (S, H), written by the dq kernel, read by the dk/dv kernel
  int S, H;
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float scale;
};

// dq (and delta) of ROWS query rows of one head
template <int D, typename T>
__global__ void __launch_bounds__(BWD_THREADS, 2) flash_segment_bwd_dq_kernel(SegBwdArgs<T> a) {
  constexpr int TPR = bwd_tpr<D>(), DPT = D / TPR, ROWS = bwd_rows<D>();
  __shared__ float k_t[BWD_TILE * D];
  __shared__ float v_t[BWD_TILE * D];
  __shared__ int seg_t[BWD_TILE];
  const int row = threadIdx.x / TPR, j = threadIdx.x % TPR;
  const int qb = blockIdx.x, h = blockIdx.y;
  const int s = qb * ROWS + row;
  const bool active = s < a.S;

  float qr[DPT], dor[DPT], acc[DPT];
  float lse = 0.f, delta = 0.f;
  int seg_q = -1;  // real ids are >= 0: a row past S matches nothing
#pragma unroll
  for (int i = 0; i < DPT; ++i) qr[i] = dor[i] = acc[i] = 0.f;
  if (active) {
    const T* qp = a.q + (long long)s * a.q_ss + (long long)h * a.q_sh;
    const long long r = ((long long)s * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[i] = to_f(qp[i * TPR + j]);
      dor[i] = to_f(a.dout[r + i * TPR + j]);
      delta = fmaf(dor[i], to_f(a.o[r + i * TPR + j]), delta);
    }
    lse = a.lse[(long long)s * a.H + h];
    seg_q = a.seg[s];
  }
  delta = row_sum<TPR>(delta);
  if (active && j == 0) a.delta[(long long)s * a.H + h] = delta;

  const T* kh = a.k + (long long)h * a.k_sh;
  const T* vh = a.v + (long long)h * a.v_sh;
  const long long k_ss = a.k_ss, v_ss = a.v_ss;
  const int first = a.first[qb], last = a.last[qb];
  for (int t0 = first; t0 < last; t0 += BWD_TILE) {
    const int n = min(BWD_TILE, last - t0);
    __syncthreads();  // the previous tile is consumed
    bwd_stage<D>(k_t, [=](int r) { return kh + (long long)(t0 + r) * k_ss; }, n);
    bwd_stage<D>(v_t, [=](int r) { return vh + (long long)(t0 + r) * v_ss; }, n);
    if (threadIdx.x < BWD_TILE) seg_t[threadIdx.x] = threadIdx.x < n ? a.seg[t0 + threadIdx.x] : -2;
    __syncthreads();
    for (int t = 0; t < n; ++t)
      bwd_pair_dq<DPT, TPR>(qr, dor, k_t + t * D + j, v_t + t * D + j, seg_t[t] == seg_q, a.scale, lse, delta, acc);
  }
  if (active) {
    T* dp = a.dq + ((long long)s * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dp[i * TPR + j] = from_f<T>(acc[i] * a.scale);
  }
}

// dk and dv of ROWS keys of one head, over the query rows of their segments
template <int D, typename T>
__global__ void __launch_bounds__(BWD_THREADS, 2) flash_segment_bwd_dkdv_kernel(SegBwdArgs<T> a) {
  constexpr int TPR = bwd_tpr<D>(), DPT = D / TPR, ROWS = bwd_rows<D>();
  __shared__ float q_t[BWD_TILE * D];
  __shared__ float do_t[BWD_TILE * D];
  __shared__ float lse_t[BWD_TILE];
  __shared__ float delta_t[BWD_TILE];
  __shared__ int seg_t[BWD_TILE];
  const int row = threadIdx.x / TPR, j = threadIdx.x % TPR;
  const int kb = blockIdx.x, h = blockIdx.y;
  const int t = kb * ROWS + row;
  const bool active = t < a.S;

  float kr[DPT], vr[DPT], dk[DPT], dv[DPT];
  int seg_k = -1;
#pragma unroll
  for (int i = 0; i < DPT; ++i) kr[i] = vr[i] = dk[i] = dv[i] = 0.f;
  if (active) {
    const T* kp = a.k + (long long)t * a.k_ss + (long long)h * a.k_sh;
    const T* vp = a.v + (long long)t * a.v_ss + (long long)h * a.v_sh;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      kr[i] = to_f(kp[i * TPR + j]);
      vr[i] = to_f(vp[i * TPR + j]);
    }
    seg_k = a.seg[t];
  }

  const T* qh = a.q + (long long)h * a.q_sh;
  const T* doh = a.dout + (long long)h * D;
  const long long q_ss = a.q_ss, do_ss = (long long)a.H * D;
  const int first = a.first[kb], last = a.last[kb];  // the query rows that see these keys
  for (int s0 = first; s0 < last; s0 += BWD_TILE) {
    const int n = min(BWD_TILE, last - s0);
    __syncthreads();
    bwd_stage<D>(q_t, [=](int r) { return qh + (long long)(s0 + r) * q_ss; }, n);
    bwd_stage<D>(do_t, [=](int r) { return doh + (long long)(s0 + r) * do_ss; }, n);
    if (threadIdx.x < BWD_TILE) {
      const int r = threadIdx.x;
      const long long x = (long long)(s0 + r) * a.H + h;
      seg_t[r] = r < n ? a.seg[s0 + r] : -2;
      lse_t[r] = r < n ? a.lse[x] : 0.f;
      delta_t[r] = r < n ? a.delta[x] : 0.f;
    }
    __syncthreads();
    for (int s = 0; s < n; ++s)
      bwd_pair_dkdv<DPT, TPR>(kr, vr, q_t + s * D + j, do_t + s * D + j, seg_t[s] == seg_k, a.scale, lse_t[s],
                              delta_t[s], dk, dv);
  }
  if (active) {
    const long long r = ((long long)t * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      a.dk[r + i * TPR + j] = from_f<T>(dk[i] * a.scale);
      a.dv[r + i * TPR + j] = from_f<T>(dv[i]);
    }
  }
}

template <int D, typename T>
static int launch_segment_bwd(const SegBwdArgs<T>& a, cudaStream_t stream) {
  const dim3 grid((a.S + bwd_rows<D>() - 1) / bwd_rows<D>(), a.H);
  flash_segment_bwd_dq_kernel<D, T><<<grid, BWD_THREADS, 0, stream>>>(a);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_segment_bwd_dkdv_kernel<D, T><<<grid, BWD_THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The tensor-core variant (bf16): flash_bwd.cuh's cores. dq runs under the forward's
// SegmentPolicy; dk/dv under SegmentKeysPolicy, the same rule seen from a block of keys.
// ---------------------------------------------------------------------------
struct SegmentKeysPolicy {
  static constexpr bool kCopiesThroughL1 = false;  // as K1's forward (flash_policy.cuh)
  int t_lo, S, H, D;
  int first, rows;  // the query rows [first, first + rows) that see these keys
  int begin, end;   // their tiles
  const int* seg;
  const __nv_bfloat16* qb;  // q + h * q_sh
  long long q_ss;
  const __nv_bfloat16* dob;  // dout + h * D; row s at s H D
  const float* lseb;         // lse + h; row s at s H
  const float* deltab;
  const __nv_bfloat16* kb;  // k + h * k_sh
  const __nv_bfloat16* vb;
  long long k_ss, v_ss;
  __nv_bfloat16* dkb;  // dk + h * D, contiguous (S, H, D)
  __nv_bfloat16* dvb;
  float scale;
  int key_id[2];      // real ids are >= 0: a key past S matches nothing
  int wid_lo, wid_hi;  // the ids of this warp's first and last key (empty: lo > hi)
  bool wfull;          // all 16 of this warp's keys lie below S

  __device__ __forceinline__ const __nv_bfloat16* any() const { return qb; }
  __device__ __forceinline__ int next_tile(int i) const { return i; }
  __device__ __forceinline__ int tile_rows(int i) const { return min(BM_BQ, rows - i * BM_BQ); }
  __device__ __forceinline__ long long row_index(int i, int r) const {
    const int rr = i * BM_BQ + r;
    return rr < rows ? (long long)(first + rr) * H : -1;
  }
  __device__ __forceinline__ const __nv_bfloat16* q_row(int i, int r) const {
    const int rr = i * BM_BQ + r;
    return rr < rows ? qb + (long long)(first + rr) * q_ss : nullptr;
  }
  __device__ __forceinline__ const __nv_bfloat16* do_row(int i, int r) const {
    const long long x = row_index(i, r);
    return x >= 0 ? dob + x * D : nullptr;
  }
  // aux: lse, delta, then segment id of each row; 0 past the tile's rows (live() checks n)
  __device__ __forceinline__ void load_aux(float* aux, int i, int tid) const {
    const int part = tid / BM_BQ, r = tid % BM_BQ;
    const long long x = row_index(i, r);
    const bool ok = x >= 0;
    const void* src = !ok ? static_cast<const void*>(lseb)
                      : part == 0 ? static_cast<const void*>(lseb + x)
                      : part == 1 ? static_cast<const void*>(deltab + x)
                                  : static_cast<const void*>(seg + first + i * BM_BQ + r);
    cp_async4_z(aux + tid, src, ok);
  }
  __device__ __forceinline__ const __nv_bfloat16* k_row(int j) const {
    return t_lo + j < S ? kb + (long long)(t_lo + j) * k_ss : nullptr;
  }
  __device__ __forceinline__ const __nv_bfloat16* v_row(int j) const {
    return t_lo + j < S ? vb + (long long)(t_lo + j) * v_ss : nullptr;
  }
  __device__ __forceinline__ void set_keys(int j_lo, int j_hi) {
    key_id[0] = t_lo + j_lo < S ? seg[t_lo + j_lo] : -1;
    key_id[1] = t_lo + j_hi < S ? seg[t_lo + j_hi] : -1;
  }
  __device__ __forceinline__ void set_warp(int j0) {
    const int t = t_lo + j0;
    wid_lo = t < S ? seg[t] : 1;
    wid_hi = t < S ? seg[min(t + 15, S - 1)] : 0;
    wfull = t + 15 < S;
  }
  // ids ascend: the tile's rows carry ids tag[0] .. tag[n - 1], the warp's keys wid_lo .. wid_hi
  __device__ __forceinline__ int warp_mode(const int* tag, int n) const {
    if (tag[n - 1] < wid_lo || tag[0] > wid_hi) return 0;
    return n == BM_BQ && wfull && wid_lo == wid_hi && tag[0] == wid_lo && tag[n - 1] == wid_lo ? 2 : 1;
  }
  __device__ __forceinline__ bool live(int h, const int* tag, int col, int n) const {
    return col < n && SegmentPolicy::rule(key_id[h], tag[col]);
  }
  __device__ __forceinline__ void store(int j, int d, float dk0, float dk1, float dv0, float dv1) const {
    const int t = t_lo + j;
    if (t >= S) return;
    const long long x = (long long)t * H * D + d;
    *reinterpret_cast<unsigned*>(dkb + x) = pack_bf16(dk0 * scale, dk1 * scale);
    *reinterpret_cast<unsigned*>(dvb + x) = pack_bf16(dv0, dv1);
  }
};

template <int D>
__global__ void __launch_bounds__(FM_THREADS, 1) flash_segment_bwd_dq_mma_kernel(SegBwdArgs<__nv_bfloat16> a) {
  extern __shared__ __align__(16) unsigned char bm_smem[];
  SegmentPolicy pol;
  pol.init(a.q, a.k, a.v, a.seg, a.first, a.last, a.S, a.q_ss, a.q_sh, a.k_ss, a.k_sh, a.v_ss, a.v_sh);
  pol.D = D;
  const int h = blockIdx.y;
  const BwdRows io{a.o + (long long)h * D, a.dout + (long long)h * D, a.lse + h, a.delta + h,
                   a.dq + (long long)h * D};
  bwd_dq_block<D>(pol, io, bm_smem, a.scale);
}

template <int D>
__global__ void __launch_bounds__(FM_THREADS, 1) flash_segment_bwd_dkdv_mma_kernel(SegBwdArgs<__nv_bfloat16> a) {
  extern __shared__ __align__(16) unsigned char bm_smem[];
  const int kblk = blockIdx.x, h = blockIdx.y;
  SegmentKeysPolicy pol;
  pol.t_lo = kblk * BM_KEYS;
  pol.S = a.S;
  pol.H = a.H;
  pol.D = D;
  pol.first = a.first[kblk];
  pol.rows = a.last[kblk] - pol.first;
  pol.begin = 0;
  pol.end = (pol.rows + BM_BQ - 1) / BM_BQ;
  pol.seg = a.seg;
  pol.qb = a.q + (long long)h * a.q_sh;
  pol.q_ss = a.q_ss;
  pol.dob = a.dout + (long long)h * D;
  pol.lseb = a.lse + h;
  pol.deltab = a.delta + h;
  pol.kb = a.k + (long long)h * a.k_sh;
  pol.vb = a.v + (long long)h * a.v_sh;
  pol.k_ss = a.k_ss;
  pol.v_ss = a.v_ss;
  pol.dkb = a.dk + (long long)h * D;
  pol.dvb = a.dv + (long long)h * D;
  pol.scale = a.scale;
  bwd_dkdv_block<D>(pol, bm_smem, a.scale);
}

template <int D>
static int launch_segment_bwd_mma(const SegBwdArgs<__nv_bfloat16>& a, cudaStream_t stream) {
  constexpr int dq_smem = bm_dq_smem_bytes<D>(), kv_smem = bm_dkdv_smem_bytes<D>();
  static const int dq_allowed = fm_allow_smem(flash_segment_bwd_dq_mma_kernel<D>, dq_smem);  // once
  static const int kv_allowed = fm_allow_smem(flash_segment_bwd_dkdv_mma_kernel<D>, kv_smem);
  if (dq_allowed != 0) return dq_allowed;
  if (kv_allowed != 0) return kv_allowed;
  const dim3 grid((a.S + BM_ROWS - 1) / BM_ROWS, a.H);
  flash_segment_bwd_dq_mma_kernel<D><<<grid, FM_THREADS, dq_smem, stream>>>(a);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_segment_bwd_dkdv_mma_kernel<D><<<grid, FM_THREADS, kv_smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace zt

// Rows per block of the backward variant a dtype and head dim get (flash_bwd.cuh's
// rule): BM_ROWS for the tensor-core kernels, fewer for the FMA ones, or
// ZT_UNSUPPORTED. The wrappers compute their key and query ranges for it.
extern "C" int zt_flash_bwd_variant(int dtype, int D) { return zt::bwd_variant_rows(dtype, D); }

// q/k/v (S, H, D) with unit stride on D; o, dout, dq, dk, dv contiguous (S, H, D) of
// q's dtype (fp32 or bf16; bf16 at D a multiple of 16 takes the mma variant, whose
// copies need 16-byte aligned bases and strides); lse and delta (S, H) fp32; first /
// last the row ranges of zt_flash_bwd_variant(dtype, D)-row blocks
// (segment_kv_ranges). Launches the dq kernel, then the dk/dv kernel, on `stream`.
extern "C" int zt_flash_segment_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                    const float* lse, const int* seg, const int* first, const int* last, void* dq,
                                    void* dk, void* dv, float* delta, int S, int H, int D, long long q_ss,
                                    long long q_sh, long long k_ss, long long k_sh, long long v_ss, long long v_sh,
                                    float scale, int dtype, void* stream) {
  using namespace zt;
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_SEG_BWD_ARGS(TT)                                                                                      \
  const SegBwdArgs<TT> a{static_cast<const TT*>(q), static_cast<const TT*>(k), static_cast<const TT*>(v),          \
                         static_cast<const TT*>(o), static_cast<const TT*>(dout), lse, seg, first, last,          \
                         static_cast<TT*>(dq), static_cast<TT*>(dk), static_cast<TT*>(dv), delta, S, H, q_ss, q_sh, \
                         k_ss, k_sh, v_ss, v_sh, scale};
  if (dtype == BF16 && bwd_variant_rows(dtype, D) == BM_ROWS) {
    ZT_SEG_BWD_ARGS(__nv_bfloat16)
    switch (D) {
      case 16: return launch_segment_bwd_mma<16>(a, st);
      case 32: return launch_segment_bwd_mma<32>(a, st);
      case 64: return launch_segment_bwd_mma<64>(a, st);
      case 80: return launch_segment_bwd_mma<80>(a, st);
      case 128: return launch_segment_bwd_mma<128>(a, st);
      default: return ZT_UNSUPPORTED;
    }
  }
  if (dtype == BF16 && D == 8) {
    ZT_SEG_BWD_ARGS(__nv_bfloat16)
    return launch_segment_bwd<8, __nv_bfloat16>(a, st);
  }
  if (dtype == F32) {
    ZT_SEG_BWD_ARGS(float)
    switch (D) {
      case 8: return launch_segment_bwd<8, float>(a, st);
      case 16: return launch_segment_bwd<16, float>(a, st);
      case 32: return launch_segment_bwd<32, float>(a, st);
      case 64: return launch_segment_bwd<64, float>(a, st);
      case 80: return launch_segment_bwd<80, float>(a, st);
      case 128: return launch_segment_bwd<128, float>(a, st);
      default: return ZT_UNSUPPORTED;
    }
  }
#undef ZT_SEG_BWD_ARGS
  return ZT_UNSUPPORTED;
}
