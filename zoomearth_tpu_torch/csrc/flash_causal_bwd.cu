// K2's backward: dq, dk and dv of causal GQA attention on the decoder's no-cache
// path (training), hand-written for Hopper.
//
// Replaces no TPU kernel: zoomearth_tpu/ops/flash_causal.py::flash_causal_attention
// has no VJP (flash_bwd.cuh says more). The query at positions[b, s] sees the kv
// slots t <= positions[b, s] with t < kv_len[b] (CausalPolicy::rule, the forward's);
// a row with no such slot gets zero gradients. bf16 or fp32 K/V only: the int8 cache
// is never trained, and the wrapper refuses it before any launch.
//
// GQA: the G = H / Hkv query heads of a kv head read the same k/v rows, so dk and dv
// of a key sum over all G heads' rows. Both variants keep the forward's fold:
// - dq: a block owns (b, kv head, ROWS / G positions) and its ROWS (head, position)
//   rows (row r is head r / bq, position r % bq) walk the keys below the block's
//   largest live bound, min(position + 1, kv_len);
// - dk/dv: a block owns (b, kv head, ROWS keys) and walks the (position, head) rows
//   of the batch row position-major in tiles of BWD_TILE rows (BWD_TILE / G
//   positions), skipping a tile whose rows all end below its first key (qhi: the
//   same bound per tile, from the wrapper); keys at or past kv_len get zeros. There
//   are few such blocks (T / ROWS x Hkv x B: 16 x 2 at the SFT path's 2048 tokens
//   with the mma variant's 128 keys), and the causal mask gives the first keys all
//   the rows and the last ones few, so the tiles are split among nsplit blocks per
//   key block (the wrapper picks nsplit from the card's SM count): each writes its
//   fp32 partial sums, and a third kernel adds the nsplit partials in split order,
//   scales dk and writes both. The sum's order is fixed: the result is the same every
//   run.
// k, v, dk and dv go through their strides, so the decoder's transposed views of its
// (B, S, Hkv, D) projections need no copy and get gradients in their own layout.
//
// The variants (bf16: the tensor-core "mma" kernels, fp32: the FMA ones), what bounds
// them and what the design does: flash_bwd.cuh.
#include "flash_bwd.cuh"

namespace zt {

template <typename E>
struct CausalBwdArgs {
  const E* q;  // (B, S, H, D) through q_sb, q_ss, q_sh
  const E* k;  // (B, Hkv, T, D) through k_sb, k_sh, k_st
  const E* v;
  const E* o;     // the forward's output, contiguous (B, S, H, D)
  const E* dout;  // its gradient, contiguous (B, S, H, D)
  const float* lse;  // (B, S, H), the forward's log-sum-exp of the scaled logits
  const int* positions;  // (B, S)
  const int* kv_len;     // (B,)
  const int* qhi;  // (B, n_qtiles): keys below it hold every key a tile of BWD_TILE / G positions sees
  E* dq;  // contiguous (B, S, H, D)
  E* dk;  // (B, Hkv, T, D) through dk_sb, dk_sh, dk_st
  E* dv;
  float* delta;  // (B, S, H), written by the dq kernel, read by the dk/dv kernel
  float* part;   // nsplit > 1: fp32 partial dk then dv, each (nsplit, B, Hkv, T, D)
  int B, S, H, Hkv, T, G, n_qtiles, nsplit;
  long long q_sb, q_ss, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st;
  float scale;
};

// dq (and delta) of the ROWS (head, position) rows of (b, kv head, ROWS / G positions)
template <int D, typename E>
__global__ void __launch_bounds__(BWD_THREADS, 2) flash_causal_bwd_dq_kernel(CausalBwdArgs<E> a) {
  constexpr int TPR = bwd_tpr<D>(), DPT = D / TPR, ROWS = bwd_rows<D>();
  __shared__ float k_t[BWD_TILE * D];
  __shared__ float v_t[BWD_TILE * D];
  const int row = threadIdx.x / TPR, j = threadIdx.x % TPR;
  const int bq = ROWS / a.G;  // positions per block
  const int s0 = blockIdx.x * bq, kh = blockIdx.y, b = blockIdx.z;
  const int g = row / bq, s = s0 + row % bq, h = kh * a.G + g;
  const bool active = s < a.S;
  const int klen = min(max(a.kv_len[b], 0), a.T);

  float qr[DPT], dor[DPT], acc[DPT];
  float lse = 0.f, delta = 0.f;
  int pos = -1;  // a row past S sees nothing
#pragma unroll
  for (int i = 0; i < DPT; ++i) qr[i] = dor[i] = acc[i] = 0.f;
  const long long x = ((long long)b * a.S + s) * a.H + h;
  if (active) {
    const E* qp = a.q + (long long)b * a.q_sb + (long long)s * a.q_ss + (long long)h * a.q_sh;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[i] = to_f(qp[i * TPR + j]);
      dor[i] = to_f(a.dout[x * D + i * TPR + j]);
      delta = fmaf(dor[i], to_f(a.o[x * D + i * TPR + j]), delta);
    }
    lse = a.lse[x];
    pos = a.positions[(long long)b * a.S + s];
  }
  delta = row_sum<TPR>(delta);
  if (active && j == 0) a.delta[x] = delta;

  int hi = 0;  // the block's key bound: its largest min(position + 1, kv_len)
  for (int i = 0; i < bq && s0 + i < a.S; ++i) hi = max(hi, min(a.positions[(long long)b * a.S + s0 + i] + 1, klen));

  const E* kb = a.k + (long long)b * a.k_sb + (long long)kh * a.k_sh;
  const E* vb = a.v + (long long)b * a.v_sb + (long long)kh * a.v_sh;
  const long long k_st = a.k_st, v_st = a.v_st;
  for (int t0 = 0; t0 < hi; t0 += BWD_TILE) {
    const int n = min(BWD_TILE, hi - t0);
    __syncthreads();  // the previous tile is consumed
    bwd_stage<D>(k_t, [=](int r) { return kb + (long long)(t0 + r) * k_st; }, n);
    bwd_stage<D>(v_t, [=](int r) { return vb + (long long)(t0 + r) * v_st; }, n);
    __syncthreads();
    for (int t = 0; t < n; ++t)
      bwd_pair_dq<DPT, TPR>(qr, dor, k_t + t * D + j, v_t + t * D + j, t0 + t <= pos && t0 + t < klen, a.scale,
                            lse, delta, acc);
  }
  if (active) {
    E* dqp = a.dq + x * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dqp[i * TPR + j] = from_f<E>(acc[i] * a.scale);
  }
}

// dk and dv of ROWS keys of (b, kv head), summed over the G query heads
template <int D, typename E>
__global__ void __launch_bounds__(BWD_THREADS, 2) flash_causal_bwd_dkdv_kernel(CausalBwdArgs<E> a) {
  constexpr int TPR = bwd_tpr<D>(), DPT = D / TPR, ROWS = bwd_rows<D>();
  __shared__ float q_t[BWD_TILE * D];
  __shared__ float do_t[BWD_TILE * D];
  __shared__ float lse_t[BWD_TILE];
  __shared__ float delta_t[BWD_TILE];
  __shared__ int pos_t[BWD_TILE];
  const int row = threadIdx.x / TPR, j = threadIdx.x % TPR;
  const int t_lo = blockIdx.x * ROWS, kh = blockIdx.y, b = blockIdx.z / a.nsplit, split = blockIdx.z % a.nsplit;
  const int t = t_lo + row;
  const int klen = min(max(a.kv_len[b], 0), a.T);
  const bool live_key = t < klen;

  float kr[DPT], vr[DPT], dk[DPT], dv[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) kr[i] = vr[i] = dk[i] = dv[i] = 0.f;
  if (live_key) {
    const E* kp = a.k + (long long)b * a.k_sb + (long long)kh * a.k_sh + (long long)t * a.k_st;
    const E* vp = a.v + (long long)b * a.v_sb + (long long)kh * a.v_sh + (long long)t * a.v_st;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      kr[i] = to_f(kp[i * TPR + j]);
      vr[i] = to_f(vp[i * TPR + j]);
    }
  }

  const int G = a.G, rows = a.S * G;  // (position, head) rows, position-major
  const E* qb = a.q + (long long)b * a.q_sb + (long long)kh * G * a.q_sh;
  const E* dob = a.dout + ((long long)b * a.S * a.H + (long long)kh * G) * D;
  const long long q_ss = a.q_ss, q_sh = a.q_sh, do_ss = (long long)a.H * D;
  const int per = (a.n_qtiles + a.nsplit - 1) / a.nsplit;  // this block's tiles: [split * per, + per)
  const int tile_hi = min(a.n_qtiles, (split + 1) * per);
  for (int tile = split * per; t_lo < klen && tile < tile_hi; ++tile) {
    if (a.qhi[(long long)b * a.n_qtiles + tile] <= t_lo) continue;  // no row of the tile sees these keys
    const int r0 = tile * BWD_TILE;
    const int n = min(BWD_TILE, rows - r0);
    __syncthreads();
    bwd_stage<D>(q_t, [=](int r) { return qb + (long long)((r0 + r) / G) * q_ss + (long long)((r0 + r) % G) * q_sh; },
                 n);
    bwd_stage<D>(do_t, [=](int r) { return dob + (long long)((r0 + r) / G) * do_ss + (long long)((r0 + r) % G) * D; },
                 n);
    if (threadIdx.x < BWD_TILE) {
      const int r = threadIdx.x, s = (r0 + r) / G;
      const long long x = ((long long)b * a.S + s) * a.H + (long long)kh * G + (r0 + r) % G;
      pos_t[r] = r < n ? a.positions[(long long)b * a.S + s] : -1;
      lse_t[r] = r < n ? a.lse[x] : 0.f;
      delta_t[r] = r < n ? a.delta[x] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < n; ++r)
      bwd_pair_dkdv<DPT, TPR>(kr, vr, q_t + r * D + j, do_t + r * D + j, live_key && t <= pos_t[r], a.scale,
                              lse_t[r], delta_t[r], dk, dv);
  }
  if (t < a.T && a.nsplit > 1) {
    const long long n = (long long)a.nsplit * a.B * a.Hkv * a.T * D;
    float* pk = a.part + ((((long long)split * a.B + b) * a.Hkv + kh) * a.T + t) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      pk[i * TPR + j] = dk[i];
      pk[n + i * TPR + j] = dv[i];
    }
  } else if (t < a.T) {
    E* dkp = a.dk + (long long)b * a.dk_sb + (long long)kh * a.dk_sh + (long long)t * a.dk_st;
    E* dvp = a.dv + (long long)b * a.dv_sb + (long long)kh * a.dv_sh + (long long)t * a.dv_st;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dkp[i * TPR + j] = from_f<E>(dk[i] * a.scale);
      dvp[i * TPR + j] = from_f<E>(dv[i]);
    }
  }
}

// dk and dv from the nsplit partials, summed in split order: one thread per element
template <typename E>
__global__ void __launch_bounds__(BWD_THREADS) flash_causal_bwd_reduce_kernel(CausalBwdArgs<E> a, int D) {
  const long long per = (long long)a.B * a.Hkv * a.T * D;
  const long long e = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  if (e >= per) return;
  float sk = 0.f, sv = 0.f;
  for (int split = 0; split < a.nsplit; ++split) {
    sk += a.part[split * per + e];
    sv += a.part[(a.nsplit + split) * per + e];
  }
  const int d = static_cast<int>(e % D);
  const long long row = e / D;  // (b, kv head, t)
  const int t = static_cast<int>(row % a.T);
  const int kh = static_cast<int>((row / a.T) % a.Hkv);
  const int b = static_cast<int>(row / ((long long)a.T * a.Hkv));
  a.dk[(long long)b * a.dk_sb + (long long)kh * a.dk_sh + (long long)t * a.dk_st + d] = from_f<E>(sk * a.scale);
  a.dv[(long long)b * a.dv_sb + (long long)kh * a.dv_sh + (long long)t * a.dv_st + d] = from_f<E>(sv);
}

template <typename E>
static int launch_causal_bwd_reduce(const CausalBwdArgs<E>& a, int D, cudaStream_t stream) {
  const long long n = (long long)a.B * a.Hkv * a.T * D;
  flash_causal_bwd_reduce_kernel<E><<<static_cast<unsigned>((n + BWD_THREADS - 1) / BWD_THREADS), BWD_THREADS, 0,
                                      stream>>>(a, D);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename E>
static int launch_causal_bwd(const CausalBwdArgs<E>& a, cudaStream_t stream) {
  constexpr int ROWS = bwd_rows<D>();
  const int bq = ROWS / a.G;
  flash_causal_bwd_dq_kernel<D, E><<<dim3((a.S + bq - 1) / bq, a.Hkv, a.B), BWD_THREADS, 0, stream>>>(a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_causal_bwd_dkdv_kernel<D, E>
      <<<dim3((a.T + ROWS - 1) / ROWS, a.Hkv, a.B * a.nsplit), BWD_THREADS, 0, stream>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || a.nsplit == 1) return rc;
  return launch_causal_bwd_reduce(a, D, stream);
}


// ---------------------------------------------------------------------------
// The tensor-core variant (bf16): flash_bwd.cuh's cores. dq runs under the forward's
// CausalPolicy; dk/dv under CausalKeysPolicy, the same rule seen from a block of keys.
// ---------------------------------------------------------------------------
struct CausalKeysPolicy {
  static constexpr bool kCopiesThroughL1 = true;  // as K2's forward (flash_policy.cuh)
  int t_lo, T, klen, S, H, G, rows, D;  // rows = S G (position, head) rows of the batch row
  int begin, end;                       // this split's query tiles
  const int* qhi;                       // this batch row's n_qtiles bounds
  const __nv_bfloat16* qb;              // q + b * q_sb + kh * G * q_sh
  long long q_ss, q_sh;
  const __nv_bfloat16* dob;  // dout + (b * S * H + kh * G) * D; row (s, g) at (s H + g) D
  const float* lseb;         // lse + b * S * H + kh * G; row (s, g) at s H + g
  const float* deltab;
  const int* posb;  // positions + b * S
  const __nv_bfloat16* kb;
  const __nv_bfloat16* vb;
  long long k_st, v_st;
  __nv_bfloat16* dkb;  // dk + b * dk_sb + kh * dk_sh
  __nv_bfloat16* dvb;
  long long dk_st, dv_st;
  float* pk;  // nsplit > 1: this split's fp32 partial dk rows (t at t D), then dv's
  float* pv;
  float scale;
  int key[2];
  int wlo;  // this warp's first key

  __device__ __forceinline__ const __nv_bfloat16* any() const { return qb; }
  __device__ __forceinline__ int next_tile(int i) const {
    while (i < end && qhi[i] <= t_lo) ++i;
    return i;
  }
  __device__ __forceinline__ int tile_rows(int i) const { return min(BM_BQ, rows - i * BM_BQ); }
  __device__ __forceinline__ long long row_index(int i, int r) const {
    const int rr = i * BM_BQ + r;
    return rr < rows ? (long long)(rr / G) * H + rr % G : -1;
  }
  __device__ __forceinline__ const __nv_bfloat16* q_row(int i, int r) const {
    const int rr = i * BM_BQ + r;
    return rr < rows ? qb + (long long)(rr / G) * q_ss + (long long)(rr % G) * q_sh : nullptr;
  }
  __device__ __forceinline__ const __nv_bfloat16* do_row(int i, int r) const {
    const long long x = row_index(i, r);
    return x >= 0 ? dob + x * D : nullptr;
  }
  // aux: lse, delta, then position of each row; 0 past the tile's rows
  __device__ __forceinline__ void load_aux(float* aux, int i, int tid) const {
    const int part = tid / BM_BQ, r = tid % BM_BQ;
    const long long x = row_index(i, r);
    const bool ok = x >= 0;
    const void* src = !ok ? static_cast<const void*>(lseb)
                      : part == 0 ? static_cast<const void*>(lseb + x)
                      : part == 1 ? static_cast<const void*>(deltab + x)
                                  : static_cast<const void*>(posb + (i * BM_BQ + r) / G);
    cp_async4_z(aux + tid, src, ok);
  }
  __device__ __forceinline__ const __nv_bfloat16* k_row(int j) const {
    return t_lo + j < T ? kb + (long long)(t_lo + j) * k_st : nullptr;
  }
  __device__ __forceinline__ const __nv_bfloat16* v_row(int j) const {
    return t_lo + j < T ? vb + (long long)(t_lo + j) * v_st : nullptr;
  }
  __device__ __forceinline__ void set_keys(int j_lo, int j_hi) {
    key[0] = t_lo + j_lo;
    key[1] = t_lo + j_hi;
  }
  __device__ __forceinline__ void set_warp(int j0) { wlo = t_lo + j0; }
  // one row a lane: the tile's largest and smallest bound against the warp's 16 keys
  __device__ __forceinline__ int warp_mode(const int* tag, int n) const {
    const int lane = threadIdx.x % 32;
    const int pos = min(tag[lane], T - 1);
    int pmax = lane < n ? pos : -1, pmin = lane < n ? pos : T;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
      pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
    }
    if (min(pmax + 1, klen) <= wlo) return 0;
    return n == BM_BQ && wlo + 16 <= min(pmin + 1, klen) ? 2 : 1;
  }
  __device__ __forceinline__ bool live(int h, const int* tag, int col, int n) const {
    return col < n && CausalPolicy<__nv_bfloat16>::rule(key[h], tag[col], klen);
  }
  __device__ __forceinline__ void store(int j, int d, float dk0, float dk1, float dv0, float dv1) const {
    const int t = t_lo + j;
    if (t >= T) return;
    if (pk != nullptr) {
      *reinterpret_cast<float2*>(pk + (long long)t * D + d) = make_float2(dk0, dk1);
      *reinterpret_cast<float2*>(pv + (long long)t * D + d) = make_float2(dv0, dv1);
    } else {
      *reinterpret_cast<unsigned*>(dkb + (long long)t * dk_st + d) = pack_bf16(dk0 * scale, dk1 * scale);
      *reinterpret_cast<unsigned*>(dvb + (long long)t * dv_st + d) = pack_bf16(dv0, dv1);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(FM_THREADS, 1) flash_causal_bwd_dq_mma_kernel(CausalBwdArgs<__nv_bfloat16> a) {
  extern __shared__ __align__(16) unsigned char bm_smem[];
  __shared__ int pos_s[FM_ROWS];
  CausalPolicy<__nv_bfloat16> pol;
  // the blocks of the latest positions, which walk the most keys, start first: less of a tail
  pol.init(gridDim.x - 1 - blockIdx.x, a.q, a.k, a.v, a.positions, a.kv_len, pos_s, a.S, a.T, a.G, a.q_sb, a.q_ss,
           a.q_sh, a.k_sb, a.k_sh, a.k_st, a.v_sb, a.v_sh, a.v_st);
  pol.D = D;
  const long long base = (long long)blockIdx.z * a.S * a.H + (long long)blockIdx.y * a.G;
  const BwdRows io{a.o + base * D, a.dout + base * D, a.lse + base, a.delta + base, a.dq + base * D};
  bwd_dq_block<D>(pol, io, bm_smem, a.scale);
}

template <int D>
__global__ void __launch_bounds__(FM_THREADS, 1) flash_causal_bwd_dkdv_mma_kernel(CausalBwdArgs<__nv_bfloat16> a) {
  extern __shared__ __align__(16) unsigned char bm_smem[];
  const int kh = blockIdx.y, b = blockIdx.z / a.nsplit, split = blockIdx.z % a.nsplit;
  const int per = (a.n_qtiles + a.nsplit - 1) / a.nsplit;  // this block's tiles: [split * per, + per)
  const long long base = (long long)b * a.S * a.H + (long long)kh * a.G;
  CausalKeysPolicy pol;
  pol.t_lo = blockIdx.x * BM_KEYS;
  pol.T = a.T;
  pol.klen = min(max(a.kv_len[b], 0), a.T);
  pol.S = a.S;
  pol.H = a.H;
  pol.G = a.G;
  pol.rows = a.S * a.G;
  pol.D = D;
  pol.begin = split * per;
  pol.end = min(a.n_qtiles, (split + 1) * per);
  pol.qhi = a.qhi + (long long)b * a.n_qtiles;
  pol.qb = a.q + (long long)b * a.q_sb + (long long)kh * a.G * a.q_sh;
  pol.q_ss = a.q_ss;
  pol.q_sh = a.q_sh;
  pol.dob = a.dout + base * D;
  pol.lseb = a.lse + base;
  pol.deltab = a.delta + base;
  pol.posb = a.positions + (long long)b * a.S;
  pol.kb = a.k + (long long)b * a.k_sb + (long long)kh * a.k_sh;
  pol.vb = a.v + (long long)b * a.v_sb + (long long)kh * a.v_sh;
  pol.k_st = a.k_st;
  pol.v_st = a.v_st;
  pol.dkb = a.dk + (long long)b * a.dk_sb + (long long)kh * a.dk_sh;
  pol.dvb = a.dv + (long long)b * a.dv_sb + (long long)kh * a.dv_sh;
  pol.dk_st = a.dk_st;
  pol.dv_st = a.dv_st;
  pol.pk = pol.pv = nullptr;
  if (a.nsplit > 1) {
    const long long n = (long long)a.nsplit * a.B * a.Hkv * a.T * D;
    pol.pk = a.part + (((long long)split * a.B + b) * a.Hkv + kh) * a.T * D;
    pol.pv = pol.pk + n;
  }
  pol.scale = a.scale;
  bwd_dkdv_block<D>(pol, bm_smem, a.scale);
}

template <int D>
static int launch_causal_bwd_mma(const CausalBwdArgs<__nv_bfloat16>& a, cudaStream_t stream) {
  constexpr int dq_smem = bm_dq_smem_bytes<D>(), kv_smem = bm_dkdv_smem_bytes<D>();
  static const int dq_allowed = fm_allow_smem(flash_causal_bwd_dq_mma_kernel<D>, dq_smem);  // once
  static const int kv_allowed = fm_allow_smem(flash_causal_bwd_dkdv_mma_kernel<D>, kv_smem);
  if (dq_allowed != 0) return dq_allowed;
  if (kv_allowed != 0) return kv_allowed;
  const int bq = FM_ROWS / a.G;
  flash_causal_bwd_dq_mma_kernel<D><<<dim3((a.S + bq - 1) / bq, a.Hkv, a.B), FM_THREADS, dq_smem, stream>>>(a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  flash_causal_bwd_dkdv_mma_kernel<D>
      <<<dim3((a.T + BM_KEYS - 1) / BM_KEYS, a.Hkv, a.B * a.nsplit), FM_THREADS, kv_smem, stream>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || a.nsplit == 1) return rc;
  return launch_causal_bwd_reduce(a, D, stream);
}

}  // namespace zt

// q (B, S, H, D) and k/v/dk/dv (B, Hkv, T, D) with unit stride on D; o, dout, dq
// contiguous (B, S, H, D), all of one dtype (fp32 or bf16; bf16 at D = 16, 32, 64 or
// 128 takes the mma variant, whose copies need 16-byte aligned bases and strides);
// lse and delta (B, S, H) fp32; positions (B, S) and kv_len (B,) int32; qhi (B,
// n_qtiles) int32 from block_key_bounds at BWD_TILE / G positions a tile. G = H / Hkv
// divides BWD_TILE. The blocks of keys are of bwd_variant_rows(dtype, D) keys, and
// nsplit blocks share each; above 1, part is fp32 scratch of 2 x nsplit x B x Hkv x T
// x D. Launches the dq kernel, the dk/dv kernel and, above one split, the kernel that
// adds the partials, on `stream`.
extern "C" int zt_flash_causal_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                   const float* lse, const int* positions, const int* kv_len, const int* qhi,
                                   void* dq, void* dk, void* dv, float* delta, float* part, int B, int S, int H,
                                   int Hkv, int T, int D, int n_qtiles, int nsplit, long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
                                   long long v_st, long long dk_sb, long long dk_sh, long long dk_st,
                                   long long dv_sb, long long dv_sh, long long dv_st, float scale, int dtype,
                                   void* stream) {
  using namespace zt;
  cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || BWD_TILE % (H / Hkv) != 0 || nsplit < 1 || (nsplit > 1 && part == nullptr))
    return ZT_UNSUPPORTED;
  const int G = H / Hkv;
  const int rows = bwd_variant_rows(dtype, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_CAU_BWD_ARGS(EE)                                                                                    \
  const CausalBwdArgs<EE> a{static_cast<const EE*>(q), static_cast<const EE*>(k), static_cast<const EE*>(v),    \
                            static_cast<const EE*>(o), static_cast<const EE*>(dout), lse, positions, kv_len, qhi, \
                            static_cast<EE*>(dq), static_cast<EE*>(dk), static_cast<EE*>(dv), delta, part, B, S,  \
                            H, Hkv, T, G, n_qtiles, nsplit, q_sb, q_ss, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, \
                            dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st, scale};
  if (dtype == BF16 && rows == BM_ROWS) {
    ZT_CAU_BWD_ARGS(__nv_bfloat16)
    switch (D) {
      case 16: return launch_causal_bwd_mma<16>(a, st);
      case 32: return launch_causal_bwd_mma<32>(a, st);
      case 64: return launch_causal_bwd_mma<64>(a, st);
      case 128: return launch_causal_bwd_mma<128>(a, st);
      default: return ZT_UNSUPPORTED;
    }
  }
  if (dtype == F32) {
    ZT_CAU_BWD_ARGS(float)
    switch (D) {
      case 16: return launch_causal_bwd<16, float>(a, st);
      case 32: return launch_causal_bwd<32, float>(a, st);
      case 64: return launch_causal_bwd<64, float>(a, st);
      case 128: return launch_causal_bwd<128, float>(a, st);
      default: return ZT_UNSUPPORTED;
    }
  }
#undef ZT_CAU_BWD_ARGS
  return ZT_UNSUPPORTED;
}
