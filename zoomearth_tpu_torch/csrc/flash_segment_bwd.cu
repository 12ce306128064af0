// K1's backward: dq, dk and dv of packed varlen (segment-id) self-attention, for
// training the ViT, hand-written for Hopper.
//
// Replaces no TPU kernel: zoomearth_tpu/ops/flash_attention.py::flash_segment_attention
// has no VJP (flash_bwd.cuh says more). Row s sees the rows t with seg[t] == seg[s]
// (ids ascending, pad rows sharing PAD_SEG and seeing each other), so the mask is
// symmetric: the query rows that see a block of keys are exactly the key range
// segment_kv_ranges gives that block as a block of queries, and one pair of range
// arrays (per block of ROWS rows) serves both kernels.
//
// What bounds it and what the design does: flash_bwd.cuh. At the ViT's full-attention
// blocks a block of keys of one 5476-patch image walks all 5476 query rows; at the
// windowed blocks (segments of at most 64 rows) every block walks one or two windows.
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

}  // namespace zt

// Rows per block of the backward kernels of K1 and K2 at head dim D (the block size
// the wrappers compute their key and query ranges for), or ZT_UNSUPPORTED.
extern "C" int zt_flash_bwd_rows(int D) {
  using namespace zt;
  switch (D) {
    case 8: return bwd_rows<8>();
    case 16: return bwd_rows<16>();
    case 32: return bwd_rows<32>();
    case 64: return bwd_rows<64>();
    case 80: return bwd_rows<80>();
    case 128: return bwd_rows<128>();
    default: return ZT_UNSUPPORTED;
  }
}

// q/k/v (S, H, D) with unit stride on D; o, dout, dq, dk, dv contiguous (S, H, D) of
// q's dtype (fp32 or bf16); lse and delta (S, H) fp32; first / last the row ranges of
// zt_flash_bwd_rows(D)-row blocks (segment_kv_ranges). Launches the dq kernel, then the
// dk/dv kernel, on `stream`.
extern "C" int zt_flash_segment_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                    const float* lse, const int* seg, const int* first, const int* last, void* dq,
                                    void* dk, void* dv, float* delta, int S, int H, int D, long long q_ss,
                                    long long q_sh, long long k_ss, long long k_sh, long long v_ss, long long v_sh,
                                    float scale, int dtype, void* stream) {
  using namespace zt;
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_SEG_BWD(DD, TT)                                                                                    \
  {                                                                                                           \
    const SegBwdArgs<TT> a{static_cast<const TT*>(q), static_cast<const TT*>(k), static_cast<const TT*>(v),    \
                           static_cast<const TT*>(o), static_cast<const TT*>(dout), lse, seg, first, last,    \
                           static_cast<TT*>(dq), static_cast<TT*>(dk), static_cast<TT*>(dv), delta, S, H, q_ss, \
                           q_sh, k_ss, k_sh, v_ss, v_sh, scale};                                              \
    return launch_segment_bwd<DD, TT>(a, st);                                                                 \
  }
#define ZT_SEG_BWD_D(TT)             \
  switch (D) {                       \
    case 8: ZT_SEG_BWD(8, TT)        \
    case 16: ZT_SEG_BWD(16, TT)      \
    case 32: ZT_SEG_BWD(32, TT)      \
    case 64: ZT_SEG_BWD(64, TT)      \
    case 80: ZT_SEG_BWD(80, TT)      \
    case 128: ZT_SEG_BWD(128, TT)    \
    default: return ZT_UNSUPPORTED;  \
  }
  if (dtype == F32) ZT_SEG_BWD_D(float)
  if (dtype == BF16) ZT_SEG_BWD_D(__nv_bfloat16)
#undef ZT_SEG_BWD_D
#undef ZT_SEG_BWD
  return ZT_UNSUPPORTED;
}
