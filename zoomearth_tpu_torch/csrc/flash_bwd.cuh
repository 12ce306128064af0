// What the backward kernels of K1 (flash_segment_bwd.cu) and K2 (flash_causal_bwd.cu)
// share: the variant rule, the tensor-core cores and the FMA variant's per-pair
// arithmetic.
//
// No TPU kernel is replaced: the reference's Pallas K1 and K2 have no VJP
// (zoomearth_tpu/models/decoder.py:118 "inference-only"; jax.grad through the
// pallas_call of zoomearth_tpu/ops/flash_attention.py:156 raises
// NotImplementedError), and the JAX package trains through XLA's autodiff of the
// plain attention. These kernels compute that gradient without the (S, T) matrices.
//
// The formulas (flash attention's backward; scaled logits z = scale * q.k, lse the
// forward's log-sum-exp of z over the row's live keys, delta = rowsum(dO * O)):
//   p = exp(z - lse) on live pairs, 0 elsewhere
//   dv_t = sum_s p_st dO_s        dp_st = dO_s . v_t
//   ds_st = p_st (dp_st - delta_s)
//   dq_s = scale sum_t ds_st k_t  dk_t = scale sum_s ds_st q_s
// A row with no live key has no live pair, so it gets zero gradients and adds
// nothing to dk or dv, whatever its lse holds. Its lse is NEG_INF, as is a masked
// logit, so z - lse = 0 there and the exponent would give 1: p is zeroed by the mask
// or liveness test itself (a select, never a product), never by the exponent.
//
// Two variants, chosen in C from the dtype and head dim (bwd_variant_rows,
// zt_flash_bwd_variant): both launch two kernels that recompute P, with no atomics,
// so the result is the same bits every run. The dq kernel goes first and writes
// delta for every row; the dk/dv kernel, launched after it on the same stream,
// reads it.
//
// - "mma" (bf16, D a multiple of 16 up to 128: the model's path, D = 80 and 128):
//   the forward's core (flash_mma.cuh: its cp.async ring, FmLayout's padded rows,
//   mma.sync m16n8k16 with ldmatrix, the policies' needs_mask tile skip and mask
//   rule from flash_policy.cuh). mma.sync at every head dim: the forward ran no faster
//   on wgmma, the L2 tile copies bound it.
//   dq: a block owns BM_ROWS = 128 query rows (16 a warp; K2 folds the G heads of a
//   kv head as its forward does), keeps their Q and dO in shared memory, computes
//   delta, and walks its key range in tiles of FM_BKV = 64 keys through a ring of
//   BM_STAGES: per tile and warp S = Q K^T and dP = dO V^T, P = 2^(S scale log2e -
//   lse log2e) masked, dS = P (dP - delta), dQ += dS K.
//   dk/dv: a block owns BM_KEYS = 128 keys of one (kv) head, 16 a warp, keeps their K
//   and V in shared memory, and walks the query rows that see them in tiles of BM_BQ
//   = 32 rows (with their lse, delta and segment id or position) through a ring of
//   BM_STAGES: per tile and warp S^T = K Q^T and dP^T = V dO^T, P^T and dS^T as above,
//   dV += P^T dO and dK += dS^T Q, the transposed operands read by ldmatrix .trans.
//   P and dS are rounded to bf16 only as the A operand of the next product, in
//   registers; every sum is fp32. A warp skips a tile none of its pairs is live in,
//   and compares only where its pairs are not all live.
//   Seven products per live pair (S and dP twice) against the five work_bwd()
//   counts: 5/7 = 71 % of the bound is this design's ceiling.
//   Tile heights: 128 rows and keys a block, as the forward, so a key tile copied from
//   L2 serves 128 rows; at K1's windowed blocks (segments of 16-64 rows) a 128-row
//   block spans two or three windows, and the warp skip keeps each warp to the one or
//   two 64-key tiles its own 16 rows see, instead of the whole block's range.
//   K2's dk/dv side has T / 128 x Hkv x B blocks (32 at the SFT path's 2048 tokens),
//   so each block of keys splits its query tiles over nsplit blocks (the wrapper
//   derives nsplit from the SM count): fp32 partials, added in split order by a
//   third kernel. K1 has S / 128 x H blocks a side (1024 at 8192 patches) and no split.
// - "fma" (fp32, and D = 8): the first version, kept for the fp32 parity runs, which
//   bf16 products would cost their precision: fp32 FMA arithmetic on fp32 copies of
//   the tiles in shared memory. dq: a block owns ROWS query rows and walks their key
//   range in tiles of BWD_TILE keys; its prologue computes delta. dk/dv: a block owns
//   ROWS keys, holds their k and v rows and dk/dv accumulators in registers, and walks
//   the query rows that see them in tiles of BWD_TILE rows. A row's D values are
//   spread over TPR threads (thread j owns dims i * TPR + j); dot products end in a
//   TPR-lane shuffle sum. 7 D fused multiply-adds per live pair at the fp32 rate.
//
// What bounds them on the card: operations (the five products of the bound are
// 10 D flops a live pair). The mma variant's measured share of that bound and what
// holds it there: PERF.md.
#pragma once

#include "flash_policy.cuh"

namespace zt {

constexpr int BWD_THREADS = 256;
constexpr int BWD_TILE = 32;  // keys (dq) or query rows (dk/dv) per shared-memory tile

// threads per row: 8 from D = 64 on (at most 16 dims, so 4 D-wide register arrays fit
// two blocks an SM), 4 below
template <int D>
__host__ __device__ constexpr int bwd_tpr() {
  return D >= 64 ? 8 : 4;
}

template <int D>
__host__ __device__ constexpr int bwd_rows() {
  return BWD_THREADS / bwd_tpr<D>();
}

// sum over the TPR consecutive lanes of one row
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage BWD_TILE rows of D values (row r at base(r), unit stride; rows past `n` as
// zeros) into an fp32 tile of shared memory.
template <int D, typename Row>
__device__ __forceinline__ void bwd_stage(float* tile, Row base, int n) {
  for (int idx = threadIdx.x; idx < BWD_TILE * D; idx += BWD_THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    tile[idx] = r < n ? to_f(base(r)[d]) : 0.f;
  }
}

// One live-or-dead pair seen from the dq side: this thread's dims of q and dO
// against the key row kr / value row vr of a tile (fp32, stride TPR from this thread's
// first dim). Adds ds * k to acc and returns nothing: p is 0 on a dead pair.
template <int DPT, int TPR>
__device__ __forceinline__ void bwd_pair_dq(const float (&qr)[DPT], const float (&dor)[DPT], const float* kr,
                                            const float* vr, bool live, float scale, float lse, float delta,
                                            float (&acc)[DPT]) {
  float z = 0.f, dp = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    z = fmaf(qr[i], kr[i * TPR], z);
    dp = fmaf(dor[i], vr[i * TPR], dp);
  }
  z = row_sum<TPR>(z);
  dp = row_sum<TPR>(dp);
  const float p = live ? expf(z * scale - lse) : 0.f;
  const float ds = p * (dp - delta);
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = fmaf(ds, kr[i * TPR], acc[i]);
}

// The same pair seen from the dk/dv side: this thread's dims of k and v against the
// query row qs / output-gradient row dos of a tile. Adds p dO to dv and ds q to dk.
template <int DPT, int TPR>
__device__ __forceinline__ void bwd_pair_dkdv(const float (&kr)[DPT], const float (&vr)[DPT], const float* qs,
                                              const float* dos, bool live, float scale, float lse, float delta,
                                              float (&dk)[DPT], float (&dv)[DPT]) {
  float z = 0.f, dp = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    z = fmaf(qs[i * TPR], kr[i], z);
    dp = fmaf(dos[i * TPR], vr[i], dp);
  }
  z = row_sum<TPR>(z);
  dp = row_sum<TPR>(dp);
  const float p = live ? expf(z * scale - lse) : 0.f;
  const float ds = p * (dp - delta);
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    dv[i] = fmaf(p, dos[i * TPR], dv[i]);
    dk[i] = fmaf(ds, qs[i * TPR], dk[i]);
  }
}


// ---------------------------------------------------------------------------
// The variant rule and the tensor-core ("mma") cores.
// ---------------------------------------------------------------------------
constexpr int BM_ROWS = FM_ROWS;    // dq: query rows per block, 16 a warp
constexpr int BM_KEYS = FM_ROWS;    // dk/dv: keys per block, 16 a warp
constexpr int BM_BQ = BWD_TILE;     // dk/dv: query rows per tile, one a lane in the warp's tests
constexpr int BM_STAGES = FM_STAGES;  // the forward's ring depth
static_assert(BM_BQ == 32 && BM_STAGES >= 2, "tile shapes");

// Rows per block of the variant a dtype and head dim get: BM_ROWS (mma: bf16, D a
// multiple of 16 up to 128), bwd_rows<D>() (fma: fp32, or D = 8) or ZT_UNSUPPORTED.
// K1's key and query ranges and K2's blocks of keys are per this many rows.
__host__ __device__ inline int bwd_variant_rows(int dtype, int D) {
  if (dtype != F32 && dtype != BF16) return ZT_UNSUPPORTED;
  if (dtype == BF16 && D % 16 == 0 && D >= 16 && D <= 128) return BM_ROWS;
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

// dynamic shared memory of the dq kernel: Q and dO rows, the k/v ring with its aux
// values (FmLayout's padded rows), delta
template <int D>
constexpr int bm_dq_smem_bytes() {
  constexpr int LD = FmLayout<D, false>::LD;
  return 2 * BM_ROWS * LD * 2 + BM_STAGES * (2 * FM_BKV * LD * 2 + 2 * FM_BKV * 4) + BM_ROWS * 4;
}

// of the dk/dv kernel: K and V rows, the Q/dO ring with each row's lse, delta and tag
template <int D>
constexpr int bm_dkdv_smem_bytes() {
  constexpr int LD = FmLayout<D, false>::LD;
  return 2 * BM_KEYS * LD * 2 + BM_STAGES * (2 * BM_BQ * LD * 2 + 3 * BM_BQ * 4);
}

// Copy `rows` rows of D bf16 values from two sources into two tiles of FmLayout L (k
// and v, or q and dO), 16 bytes a copy spread over FM_THREADS threads, one vector of
// each in turn: src(r, a, b) names row r's two sources, nullptr where the tile has no
// such row (zeros then; `any`, a readable address, stands in for the source).
template <typename L, bool L1, typename Src>
__device__ __forceinline__ void bm_copy_rows(__nv_bfloat16* dst_a, __nv_bfloat16* dst_b, int rows, Src src,
                                             const __nv_bfloat16* any, int tid) {
  for (int e = tid; e < rows * L::VPR; e += FM_THREADS) {
    int row, vec;
    L::chunk(e, row, vec);
    const __nv_bfloat16* a;
    const __nv_bfloat16* b;
    src(row, a, b);
    const int o = L::off(row, vec);
    cp_async16_z<L1>(dst_a + o, a != nullptr ? a + vec * 8 : any, a != nullptr);
    cp_async16_z<L1>(dst_b + o, b != nullptr ? b + vec * 8 : any, b != nullptr);
  }
}

// Where a dq block's rows read and write: row r at index x = pol.row_index(r) has its
// forward output at o + x D, its gradient at dout + x D, its lse at lse[x]; delta[x]
// and dq + x D are written. Bases are the block's (the policy's row_index counts from it).
struct BwdRows {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;
  float* delta;
  __nv_bfloat16* dq;
};

// dq (and delta) of one block of BM_ROWS query rows, under a policy of
// flash_policy.cuh; FM_THREADS threads.
template <int D, typename Policy>
__device__ __forceinline__ void bwd_dq_block(Policy& pol, const BwdRows& io, unsigned char* smem, float scale) {
  using L = FmLayout<D, false>;
  constexpr int LD = L::LD, NT = FM_BKV / 8, DT = D / 8;
  constexpr int HALF = FM_BKV * LD, TILE = 2 * HALF;  // a k tile, then its v tile
  constexpr bool L1 = Policy::kCopiesThroughL1;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + BM_ROWS * LD;
  __nv_bfloat16* tiles = dos + BM_ROWS * LD;
  int* aux_ring = reinterpret_cast<int*>(tiles + BM_STAGES * TILE);
  float* delta_s = reinterpret_cast<float*>(aux_ring + BM_STAGES * 2 * FM_BKV);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lo = pol.lo, hi = pol.hi;
  const int ntiles = (max(hi - lo, 0) + FM_BKV - 1) / FM_BKV;

  // tile i into stage i % BM_STAGES; one group per call, empty past the last tile
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      const int st = i % BM_STAGES, t0 = lo + i * FM_BKV;
      __nv_bfloat16* kd = tiles + st * TILE;
      bm_copy_rows<L, L1>(
          kd, kd + HALF, FM_BKV,
          [&](int row, const __nv_bfloat16*& a, const __nv_bfloat16*& b) {
            const bool ok = t0 + row < hi;
            a = ok ? pol.k_row(t0 + row) : nullptr;
            b = ok ? pol.v_row(t0 + row) : nullptr;
          },
          pol.k_row(lo), tid);
      pol.load_aux(aux_ring + st * 2 * FM_BKV, t0, tid);
    }
    cp_async_commit();
  };

  // the block's Q and dO rows ride with tile 0's group
  bm_copy_rows<L, L1>(
      qs, dos, BM_ROWS,
      [&](int r, const __nv_bfloat16*& a, const __nv_bfloat16*& b) {
        const long long x = pol.row_index(r);
        a = pol.q_row(r);
        b = x >= 0 ? io.dout + x * D : nullptr;
      },
      pol.q_row_any(), tid);
#pragma unroll
  for (int i = 0; i < BM_STAGES - 1; ++i) load_tile(i);

  // delta = rowsum(dO * O) in fp32, two threads a row, D / 2 values each in 16-byte loads
  {
    const int r = tid / 2, part = tid % 2;
    const long long x = pol.row_index(r);
    float d = 0.f;
    if (x >= 0) {
      const uint4* pa = reinterpret_cast<const uint4*>(io.dout + x * D + part * (D / 2));
      const uint4* pb = reinterpret_cast<const uint4*>(io.o + x * D + part * (D / 2));
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const uint4 va = pa[i], vb = pb[i];
        const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&va);
        const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&vb);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(ha[e]), fb = __bfloat1622float2(hb[e]);
          d = fmaf(fa.x, fb.x, d);
          d = fmaf(fa.y, fb.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (part == 0) {
      delta_s[r] = d;
      if (x >= 0) io.delta[x] = d;
    }
  }
  __syncthreads();

  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;  // this thread's two rows
  pol.set_rows(r_lo, r_hi);
  pol.set_warp(warp * 16);
  float lse2[2], dlt[2];  // lse in base 2 (0 where the block has no row: its dO is 0), delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long x = pol.row_index(h == 0 ? r_lo : r_hi);
    lse2[h] = x >= 0 ? io.lse[x] * LOG2E : 0.f;
    dlt[h] = delta_s[h == 0 ? r_lo : r_hi];
  }
  const float scale2 = scale * LOG2E;
  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<BM_STAGES - 2>();
    __syncthreads();  // tile i has arrived for every thread, and tile i - 1 is consumed
    load_tile(i + BM_STAGES - 1);
    const int st = i % BM_STAGES, t0 = lo + i * FM_BKV;
    const int* aux = aux_ring + st * 2 * FM_BKV;
    const __nv_bfloat16* kt = tiles + st * TILE;
    if (pol.warp_skips(aux, t0)) continue;
    float s[NT][4], dp[NT][4];
    mma_rows_abt<D, NT, LD>(s, qs + warp * 16 * LD, kt, lane);
    mma_rows_abt<D, NT, LD>(dp, dos + warp * 16 * LD, kt + HALF, lane);
    const bool masked = pol.needs_mask(aux, t0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1), h = e >> 1;
        float p = fast_exp2(fmaf(s[j][e], scale2, -lse2[h]));
        if (masked && !pol.live(h, aux, col, t0 + col)) p = 0.f;
        s[j][e] = p * (dp[j][e] - dlt[h]);  // dS
      }
    }
    unsigned da[NT / 2][4];
    mma_c_to_a<NT / 2>(da, s);
    mma_rows_pv<DT, NT / 2, LD>(dq, da, kt, lane);
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long x = pol.row_index(h == 0 ? r_lo : r_hi);
    if (x < 0) continue;
    __nv_bfloat16* out = io.dq + x * D;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<unsigned*>(out + j * 8 + 2 * t4) = pack_bf16(dq[j][2 * h] * scale, dq[j][2 * h + 1] * scale);
  }
}

// dk and dv of one block of BM_KEYS keys, under a key-block policy (flash_segment_bwd.cu,
// flash_causal_bwd.cu): the tiles it walks (next_tile(i): the first tile from i that
// any row of which sees these keys, up to end; tile_rows(i): its rows), where tile i's
// row r reads (q_row, do_row: nullptr past its rows) and its lse, delta and tag
// (load_aux: cp.async of the three 4-byte values of rows 0 .. BM_BQ - 1 into aux[0 ..
// 3 BM_BQ), 0 past the tile's rows), the block's key j (k_row, v_row: nullptr past
// the keys), set_keys / set_warp (this thread's two keys, this warp's 16 keys from
// j0), warp_mode(tag, n) (0: no pair of the warp's keys with the tile's n rows is
// live; 1: some are; 2: all are), live(h, tag, col, n) (key h's pair with row col) and
// store(j, d, dk0, dk1, dv0, dv1) (dims d, d + 1 of key j; dk before its scale, which
// store or the split sum applies); FM_THREADS threads.
template <int D, typename KP>
__device__ __forceinline__ void bwd_dkdv_block(KP& pol, unsigned char* smem, float scale) {
  using L = FmLayout<D, false>;
  constexpr int LD = L::LD, NQ = BM_BQ / 8, DT = D / 8, QT = BM_BQ * LD;
  constexpr bool L1 = KP::kCopiesThroughL1;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + BM_KEYS * LD;
  __nv_bfloat16* ring = vs + BM_KEYS * LD;  // per stage a Q tile, then its dO tile
  float* aux_ring = reinterpret_cast<float*>(ring + BM_STAGES * 2 * QT);  // per stage lse, delta, tag

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const __nv_bfloat16* any = pol.any();

  // the block's K and V ride with the first tile's group
  bm_copy_rows<L, L1>(
      ks, vs, BM_KEYS,
      [&](int j, const __nv_bfloat16*& a, const __nv_bfloat16*& b) {
        a = pol.k_row(j);
        b = pol.v_row(j);
      },
      any, tid);
  int next = pol.next_tile(pol.begin), loads = 0;  // the producer's next tile, its loads so far
  auto load_tile = [&]() {
    if (next < pol.end) {
      const int st = loads % BM_STAGES, i = next;
      __nv_bfloat16* qd = ring + st * 2 * QT;
      bm_copy_rows<L, L1>(
          qd, qd + QT, BM_BQ,
          [&](int r, const __nv_bfloat16*& a, const __nv_bfloat16*& b) {
            a = pol.q_row(i, r);
            b = pol.do_row(i, r);
          },
          any, tid);
      if (tid < 3 * BM_BQ) pol.load_aux(aux_ring + st * 3 * BM_BQ, i, tid);
      next = pol.next_tile(next + 1);
    }
    ++loads;
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < BM_STAGES - 1; ++i) load_tile();

  const int j_lo = warp * 16 + g;  // this thread's two keys: j_lo and j_lo + 8
  pol.set_keys(j_lo, j_lo + 8);
  pol.set_warp(warp * 16);
  const float scale2 = scale * LOG2E;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  int i = 0;  // live tiles consumed: tile `cur` sits in stage i % BM_STAGES
  for (int cur = pol.next_tile(pol.begin); cur < pol.end; cur = pol.next_tile(cur + 1), ++i) {
    cp_async_wait<BM_STAGES - 2>();
    __syncthreads();  // tile cur has arrived for every thread, and the one before is consumed
    load_tile();
    const int st = i % BM_STAGES;
    const __nv_bfloat16* qt = ring + st * 2 * QT;
    const __nv_bfloat16* dot = qt + QT;
    const float* lse = aux_ring + st * 3 * BM_BQ;
    const float* dlt = lse + BM_BQ;
    const int* tag = reinterpret_cast<const int*>(dlt + BM_BQ);
    const int n = pol.tile_rows(cur);
    const int mode = pol.warp_mode(tag, n);
    if (mode == 0) continue;
    float s[NQ][4], dp[NQ][4];  // S^T and dP^T: this warp's 16 keys against the tile's rows
    mma_rows_abt<D, NQ, LD>(s, ks + warp * 16 * LD, qt, lane);
    mma_rows_abt<D, NQ, LD>(dp, vs + warp * 16 * LD, dot, lane);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1), h = e >> 1;
        float p = fast_exp2(fmaf(s[j][e], scale2, -lse[col] * LOG2E));
        if (mode == 1 && !pol.live(h, tag, col, n)) p = 0.f;
        dp[j][e] = p * (dp[j][e] - dlt[col]);  // dS^T
        s[j][e] = p;                          // P^T
      }
    }
    unsigned pa[NQ / 2][4], da[NQ / 2][4];
    mma_c_to_a<NQ / 2>(pa, s);
    mma_c_to_a<NQ / 2>(da, dp);
    mma_rows_pv<DT, NQ / 2, LD>(dv, pa, dot, lane);
    mma_rows_pv<DT, NQ / 2, LD>(dk, da, qt, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < DT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pol.store(j_lo + 8 * h, j * 8 + 2 * t4, dk[j][2 * h], dk[j][2 * h + 1], dv[j][2 * h], dv[j][2 * h + 1]);
  }
}

}  // namespace zt
