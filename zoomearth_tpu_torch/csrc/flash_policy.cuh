// The mask policies of K1 (segment ids) and K2 (causal with kv_len; with a band and sinks
// for MiMo-V2.5's window layers), shared by the
// forward's tensor-core core (flash_mma.cuh: flash_segment.cu, flash_causal.cu) and
// the backward's dq kernels (flash_bwd.cuh: flash_segment_bwd.cu,
// flash_causal_bwd.cu), so that one mask rule serves both directions. The backward's
// dk/dv kernels walk query rows against a block of keys and call the same rule
// (`rule`) from their own policies.
//
// A block of FM_ROWS query rows: init() reads its geometry from blockIdx, as both
// directions lay their grids out alike (K2's backward walks its blocks of positions
// from the last). The interface flash_mma.cuh lists, plus:
// row_index(r) (row r's place in the (rows, D) tensors out, dO, dq and the (rows)
// tensors lse and delta, from the block's base; -1 where the block has no such row),
// set_warp(r0) (this warp's 16 rows from r0, all lanes together) and warp_skips(aux,
// t0) (whether none of those rows has a live key in the tile at t0).
#pragma once

#include "flash_mma.cuh"

namespace zt {

template <typename KT>
struct CausalPolicy {
  static constexpr bool QUANT = sizeof(KT) == 1;
  // K2's tile copies are cached in L1 too (cp.async.ca): one block an SM leaves L1
  // large, and on the card .ca ran 7-14 % faster there than .cg.
  static constexpr bool kCopiesThroughL1 = true;
  static constexpr bool kSink = false;
  int lo, hi;
  int full;  // keys below it are live for every row of the block
  int klen, bq, s0, S, H, D;
  const int* pos_s;  // the block's bq positions (-1 past S), shared memory
  const __nv_bfloat16* qb;  // q + b * q_sb + (kh * G) * q_sh
  long long q_ss, q_sh;
  const KT* kb;
  const KT* vb;
  long long k_st, v_st;
  const float* ksb;  // ks + b * sc_sb + kh * sc_sh (int8 K/V)
  const float* vsb;
  __nv_bfloat16* ob;  // out + (b * S * H + kh * G) * D
  float* lseb;        // lse + b * S * H + kh * G, or nullptr
  int pos_row[2];
  int warp_hi;  // keys below it hold every live key of this warp's rows

  // the query at position pos sees key slot t
  __device__ __forceinline__ static bool rule(int t, int pos, int klen) { return t <= pos && t < klen; }

  // The block (b, kv head from blockIdx, its bq = FM_ROWS / G positions from qblk) and
  // its rows (row r is head r / bq, position r % bq): positions into pos_shared (FM_ROWS
  // ints of shared memory), the key range [0, hi) up to the block's largest position + 1
  // clipped by kv_len, and `full`. The fields of one direction's outputs are left to it.
  __device__ __forceinline__ void init(int qblk, const __nv_bfloat16* q, const KT* k, const KT* v,
                                       const int* positions, const int* kv_len, int* pos_shared, int S_, int T,
                                       int G, long long q_sb, long long q_ss_, long long q_sh_, long long k_sb,
                                       long long k_sh, long long k_st_, long long v_sb, long long v_sh,
                                       long long v_st_) {
    bq = FM_ROWS / G;
    s0 = qblk * bq;
    const int kh = blockIdx.y, b = blockIdx.z;
    S = S_;
    H = gridDim.y * G;
    klen = min(max(kv_len[b], 0), T);
    for (int i = threadIdx.x; i < bq; i += blockDim.x)
      pos_shared[i] = s0 + i < S ? positions[(long long)b * S + s0 + i] : -1;
    __syncthreads();
    int pmax = -1, pmin = T;  // over the block's rows below S
    for (int i = 0; i < bq && s0 + i < S; ++i) {
      pmax = max(pmax, pos_shared[i]);
      pmin = min(pmin, pos_shared[i]);
    }
    lo = 0;
    hi = min(min(pmax, T - 1) + 1, klen);
    full = min(max(pmin, -1) + 1, klen);
    pos_s = pos_shared;
    qb = q + (long long)b * q_sb + (long long)kh * G * q_sh_;
    q_ss = q_ss_;
    q_sh = q_sh_;
    kb = k + (long long)b * k_sb + (long long)kh * k_sh;
    vb = v + (long long)b * v_sb + (long long)kh * v_sh;
    k_st = k_st_;
    v_st = v_st_;
  }
  // row r's place from (b * S * H + kh * G)
  __device__ __forceinline__ long long row_index(int r) const {
    const int s = s0 + r % bq;
    return s < S ? (long long)s * H + r / bq : -1;
  }
  __device__ __forceinline__ const __nv_bfloat16* q_row_any() const { return qb; }
  __device__ __forceinline__ const __nv_bfloat16* q_row(int r) const {
    const int s = s0 + r % bq;
    return s < S ? qb + (long long)s * q_ss + (long long)(r / bq) * q_sh : nullptr;
  }
  __device__ __forceinline__ __nv_bfloat16* out_row(int r) const {
    const long long x = row_index(r);
    return x >= 0 ? ob + x * D : nullptr;
  }
  __device__ __forceinline__ float* lse_row(int r) const {
    const long long x = row_index(r);
    return lseb != nullptr && x >= 0 ? lseb + x : nullptr;
  }
  __device__ __forceinline__ const KT* k_row(int t) const { return kb + (long long)t * k_st; }
  __device__ __forceinline__ const KT* v_row(int t) const { return vb + (long long)t * v_st; }
  __device__ __forceinline__ void load_aux(int* aux, int t0, int tid) const {
    if (QUANT && tid < 2 * FM_BKV) {
      const int col = tid % FM_BKV;
      const bool ok = t0 + col < hi;
      cp_async4_z(aux + tid, (tid < FM_BKV ? ksb : vsb) + (ok ? t0 + col : lo), ok);
    }
  }
  __device__ __forceinline__ void set_rows(int r_lo, int r_hi) {
    pos_row[0] = pos_s[r_lo % bq];
    pos_row[1] = pos_s[r_hi % bq];
  }
  __device__ __forceinline__ void set_warp(int r0) {
    const int lane = threadIdx.x % 32;
    int h = min(pos_s[(r0 + lane % 16) % bq] + 1, klen);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) h = max(h, __shfl_xor_sync(0xffffffffu, h, off));
    warp_hi = h;
  }
  __device__ __forceinline__ bool warp_skips(const int*, int t0) const { return t0 >= warp_hi; }
  __device__ __forceinline__ bool needs_mask(const int*, int t0) const { return t0 + FM_BKV > full; }
  __device__ __forceinline__ bool live(int half, const int*, int, int t) const {
    return rule(t, pos_row[half], klen);
  }
};

// K2 for MiMo-V2.5's window layers (flash_causal.cu::zt_flash_causal_band): CausalPolicy
// with a band, the query at position p seeing the keys t with p - window < t <= p (and
// t < kv_len), and a sink logit per head. The key range starts at the block's smallest
// position - window + 1, so tiles wholly below every row's window are never read, and
// the compare runs only on tiles that reach below the largest position's window edge
// (`band_full`) or past `full`.
struct BandPolicy : CausalPolicy<__nv_bfloat16> {
  static constexpr bool kSink = true;
  int window;
  int band_full;        // keys at or above it lie inside every row's window
  const float* sinkb;   // sink + kv head * G: the block's heads' sink logits, or nullptr
  float inv_scale;      // 1 / the softmax scale: a sink logit in the raw logits' units

  // after init(): the band's lower edge and the sinks (sink: (H,) fp32, or nullptr)
  __device__ __forceinline__ void init_band(int window_, const float* sink, int G, int T, float scale) {
    window = window_;
    int pmax = -1, pmin = T;
    for (int i = 0; i < bq && s0 + i < S; ++i) {
      pmax = max(pmax, pos_s[i]);
      pmin = min(pmin, pos_s[i]);
    }
    lo = max(min(pmin, T - 1) - window + 1, 0);
    band_full = pmax - window + 1;
    sinkb = sink != nullptr ? sink + (long long)blockIdx.y * G : nullptr;
    inv_scale = 1.f / scale;
  }
  __device__ __forceinline__ bool needs_mask(const int*, int t0) const {
    return t0 + FM_BKV > full || t0 < band_full;
  }
  __device__ __forceinline__ bool live(int half, const int*, int, int t) const {
    const int pos = pos_row[half];
    return t <= pos && t < klen && t > pos - window;
  }
  __device__ __forceinline__ void sink_init(int r_lo, int r_hi, int t4, float (&m)[2], float (&l)[2]) const {
    if (sinkb == nullptr) return;
    m[0] = sinkb[r_lo / bq] * inv_scale;
    m[1] = sinkb[r_hi / bq] * inv_scale;
    l[0] = l[1] = t4 == 0 ? 1.f : 0.f;
  }
};

struct SegmentPolicy {
  // K1's tile copies bypass L1 (cp.async.cg): with two blocks an SM the shared-memory
  // carve-out leaves little L1, and on the card .cg ran 15 % faster there than .ca.
  static constexpr bool kCopiesThroughL1 = false;
  static constexpr bool kSink = false;
  int lo, hi;
  int s0, S, H, D;
  int block_id;  // the block's one segment id, or -1 when its rows span several
  const int* seg;
  const __nv_bfloat16* qb;  // q + h * q_sh, and so on
  const __nv_bfloat16* kb;
  const __nv_bfloat16* vb;
  long long q_ss, k_ss, v_ss;
  __nv_bfloat16* ob;  // out + h * D
  float* lseb;        // lse + h, or nullptr
  int seg_row[2];
  int warp_lo, warp_hi;  // the segment ids of this warp's first and last rows (empty: lo > hi)

  // a key and a query of one segment see each other
  __device__ __forceinline__ static bool rule(int key_id, int query_id) { return key_id == query_id; }

  // The block (FM_ROWS rows from blockIdx.x, head blockIdx.y) and its key range, the
  // contiguous rows [kv_first, kv_last) of the segments its rows belong to.
  __device__ __forceinline__ void init(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                                       const int* seg_, const int* kv_first, const int* kv_last, int S_,
                                       long long q_ss_, long long q_sh, long long k_ss_, long long k_sh,
                                       long long v_ss_, long long v_sh) {
    const int qblk = blockIdx.x, h = blockIdx.y;
    lo = kv_first[qblk];
    hi = kv_last[qblk];
    s0 = qblk * FM_ROWS;
    S = S_;
    H = gridDim.y;
    const int id_first = seg_[s0], id_last = seg_[min(s0 + FM_ROWS, S) - 1];
    block_id = id_first == id_last ? id_first : -1;
    seg = seg_;
    qb = q + (long long)h * q_sh;
    kb = k + (long long)h * k_sh;
    vb = v + (long long)h * v_sh;
    q_ss = q_ss_;
    k_ss = k_ss_;
    v_ss = v_ss_;
  }
  // row r's place from h
  __device__ __forceinline__ long long row_index(int r) const {
    return s0 + r < S ? (long long)(s0 + r) * H : -1;
  }
  __device__ __forceinline__ const __nv_bfloat16* q_row_any() const { return qb; }
  __device__ __forceinline__ const __nv_bfloat16* q_row(int r) const {
    return s0 + r < S ? qb + (long long)(s0 + r) * q_ss : nullptr;
  }
  __device__ __forceinline__ __nv_bfloat16* out_row(int r) const {
    const long long x = row_index(r);
    return x >= 0 ? ob + x * D : nullptr;
  }
  __device__ __forceinline__ float* lse_row(int r) const {
    const long long x = row_index(r);
    return lseb != nullptr && x >= 0 ? lseb + x : nullptr;
  }
  __device__ __forceinline__ const __nv_bfloat16* k_row(int t) const { return kb + (long long)t * k_ss; }
  __device__ __forceinline__ const __nv_bfloat16* v_row(int t) const { return vb + (long long)t * v_ss; }
  // aux[col] = segment id of key t0 + col (0 past hi: live() checks the bound itself)
  __device__ __forceinline__ void load_aux(int* aux, int t0, int tid) const {
    if (tid < FM_BKV) {
      const bool ok = t0 + tid < hi;
      cp_async4_z(aux + tid, seg + (ok ? t0 + tid : lo), ok);
    }
  }
  // real ids are >= 0: a row past S matches nothing
  __device__ __forceinline__ void set_rows(int r_lo, int r_hi) {
    seg_row[0] = s0 + r_lo < S ? seg[s0 + r_lo] : -1;
    seg_row[1] = s0 + r_hi < S ? seg[s0 + r_hi] : -1;
  }
  __device__ __forceinline__ void set_warp(int r0) {
    const bool any = s0 + r0 < S;
    warp_lo = any ? seg[s0 + r0] : 1;
    warp_hi = any ? seg[min(s0 + r0 + 15, S - 1)] : 0;
  }
  // ids ascend: the tile's keys [t0, min(t0 + FM_BKV, hi)) carry ids aux[0] .. aux[n - 1]
  __device__ __forceinline__ bool warp_skips(const int* aux, int t0) const {
    const int n = min(FM_BKV, hi - t0);
    return aux[n - 1] < warp_lo || aux[0] > warp_hi;
  }
  // a whole tile whose first and last keys carry the block's one id needs no compare
  __device__ __forceinline__ bool needs_mask(const int* aux, int t0) const {
    return !(t0 + FM_BKV <= hi && aux[0] == block_id && aux[FM_BKV - 1] == block_id);
  }
  __device__ __forceinline__ bool live(int half, const int* aux, int col, int t) const {
    return t < hi && rule(aux[col], seg_row[half]);
  }
};

}  // namespace zt
