// The tensor-core flash-attention core shared by K1 (flash_segment.cu) and K2
// (flash_causal.cu): bf16 queries against bf16 or int8 keys/values, head dim a
// multiple of 16 up to 128; and, for latent attention's expanded form, bf16 keys of
// width D = 192 against values of width DV = 128 (mma.sync; the value tile and the
// output are DV wide).
//
// A block of FM_WARPS warps owns FM_ROWS = 128 query rows, 16 per warp, and walks
// the key range [lo, hi) its policy names in tiles of FM_BKV keys:
//
// - k/v tiles stay bf16 in shared memory (FmLayout: rows padded by 8 elements for
//   ldmatrix, the descriptors' core-matrix layout for wgmma) and arrive through a ring of
//   FM_STAGES stages of 16-byte cp.async copies: tile i + FM_STAGES - 1 is in flight
//   while tile i multiplies, one barrier per tile. Rows past `hi` and query rows the
//   policy does not have are filled with zeros, never left stale (0 x NaN is NaN).
// - S = Q K^T and O += P V run on the tensor cores with fp32 accumulators: at the
//   model's head dims (80 and 128) as warpgroup products (wgmma.mma_async: four warps
//   share a 64-row tile, Q and K read from shared memory through descriptors, V as
//   the transposed-B form, no operand fragment loaded by hand), at the other head dims
//   as mma.sync m16n8k16 with ldmatrix. Both leave the logits in the same fragment
//   layout, 16 rows a warp. The online softmax (running max m and sum l per row, in
//   base 2 with log2 e folded into the scale, one fused multiply-add and one ex2 per
//   weight) works on those fragments; P is rounded to bf16 in registers and is the A
//   operand of the second product, so the (rows, tile) logits never touch shared
//   memory.
// - The policy's mask is applied only on tiles that need it (needs_mask). A masked
//   logit is NEG_INF = -1e30, never -inf; a row whose keys so far are all masked
//   keeps m = NEG_INF and takes 0 as its reference, so its p are exactly 0, and a row
//   with no live key at all ends with l = 0 and writes 0.
// - int8 K/V: the raw bytes ride the ring, a tile is widened to bf16 (exact for
//   |x| <= 127) in shared memory once it has arrived, the logits' columns are
//   multiplied by ks in fp32 on the accumulator and p by vs in fp32 before it is
//   rounded to bf16; l sums the unscaled p. The same algebra as the TPU kernel.
//
// What bounds the core on the card, measured by leaving parts out (PERF.md): the
// tile copies. Every block of 128 rows reads its whole key range again from L2, and
// the copies alone take 67-87 % of the kernel's time at about 2 TB/s over all SMs,
// whichever way they are issued (cp.async .cg or .ca, plain 16-byte loads, a deeper
// ring, one hot tile); the products and the softmax alone take 56-77 %, and the two
// overlap. mma.sync and wgmma therefore run alike here. More rows per block (or one
// copy shared by a cluster) is what moves it next.
//
// A policy is a struct with: lo, hi (key range); q_row(r) / out_row(r) (pointer to
// row r's D values, nullptr where the block has no such row); k_row(t) / v_row(t);
// load_aux(aux, t0, tid) (cp.async of per-key 4-byte values for keys t0.. into
// aux[2 * FM_BKV]; for int8 K/V aux holds ks then vs); set_rows(r_lo, r_hi) (the two
// rows this thread masks); needs_mask(aux, t0); live(half, aux, col, t);
// lse_row(r) (where row r's log-sum-exp goes, fp32, or nullptr: the inference paths
// ask for none); kCopiesThroughL1 (whether the tile copies are cached in L1: .ca
// against .cg).
#pragma once

#include "common.cuh"

namespace zt {

constexpr int FM_WARPS = 8;
constexpr int FM_THREADS = FM_WARPS * 32;
constexpr int FM_ROWS = FM_WARPS * 16;  // query rows per block
constexpr int FM_BKV = 64;    // keys per tile, a multiple of 16
constexpr int FM_STAGES = 3;  // depth of the tile ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x in one instruction (relative error 2^-22, far below the bf16 rounding of p);
// very negative x gives 0, which is what a masked logit needs
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether head dim D takes the warpgroup products (the model's two head dims).
template <int D>
__host__ __device__ constexpr bool fm_wgmma() {
  return D == 80 || D == 128;
}

// Where the 16-byte vector (row, vec) of a bf16 tile of D-wide rows lies in shared
// memory, in elements. mma.sync: rows padded by 8 elements. wgmma: the no-swizzle
// core-matrix layout its descriptors name, 8 rows x 16 bytes contiguous (128 bytes)
// per core matrix, the D / 8 core matrices of 8 rows side by side, then the next 8
// rows; no padding, so D = 80 needs none either.
template <int D, bool WG>
struct FmLayout {
  static constexpr int LD = D + 8;
  static constexpr int VPR = D / 8;
  static constexpr int row_elems = WG ? D : LD;  // per row of a tile
  __device__ static __forceinline__ int off(int row, int vec) {
    return WG ? (row >> 3) * (8 * D) + vec * 64 + (row & 7) * 8 : row * LD + vec * 8;
  }
  // which vector the e-th copy of a tile moves: for wgmma eight rows of one vec in
  // turn, so that eight lanes fill one core matrix (contiguous in shared memory)
  // while each row still gets 64 contiguous bytes from a warp
  __device__ static __forceinline__ void chunk(int e, int& row, int& vec) {
    if (WG) {
      row = (e / (8 * VPR)) * 8 + (e & 7);
      vec = (e >> 3) % VPR;
    } else {
      row = e / VPR;
      vec = e % VPR;
    }
  }
};

// dynamic shared memory of one block, in bytes (DV: the value width, D where not given)
template <int D, bool QUANT, int DV = D>
constexpr int fm_smem_bytes() {
  constexpr bool WG = fm_wgmma<D>() && DV == D;
  constexpr int row = FmLayout<D, WG>::row_elems;
  constexpr int tile = FM_BKV * (row + FmLayout<DV, WG>::row_elems) * 2;  // a bf16 k tile and v tile
  return FM_ROWS * row * 2 + (QUANT ? tile + FM_STAGES * 2 * FM_BKV * D : FM_STAGES * tile) +
         FM_STAGES * 2 * FM_BKV * 4;
}

// ---------------------------------------------------------------------------
// One warp's mma.sync m16n8k16 products on bf16 rows in shared memory (row stride LD
// elements, 16-byte aligned rows, padded against bank conflicts), fp32 accumulators in
// the C-fragment layout (common.cuh):
// - mma_rows_abt: c (16 x 8 NT) = A B^T, A the 16 rows at a, B the 8 NT rows at b,
//   both D wide (S = Q K^T; in the backward also dP = dO V^T and their transposes);
// - mma_c_to_a: the bf16 A fragments of a 16 x 16 KS operand from the C fragments of
//   2 KS n8 tiles (P or dS stays in registers between the two products; the forward
//   packs its own, with the int8 value scales on the way);
// - mma_rows_pv: o (16 x 8 DT) += P V, P as those A fragments, V the 16 KS rows at v
//   (read transposed by ldmatrix .trans: O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q).
// ---------------------------------------------------------------------------
template <int D, int NT, int LD>
__device__ __forceinline__ void mma_rows_abt(float (&c)[NT][4], const __nv_bfloat16* a, const __nv_bfloat16* b,
                                             int lane) {
  static_assert(D % 16 == 0 && NT % 2 == 0, "k16 steps, n16 pairs");
  const int mi = lane / 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned af[4];
    ldmatrix_x4(af, a + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      unsigned bf[4];  // rows jp * 16 .. + 7 (bf[0], bf[1]) and + 8 .. + 15 (bf[2], bf[3])
      ldmatrix_x4(bf, b + (jp * 16 + (mi / 2) * 8 + lane % 8) * LD + kk * 16 + (mi % 2) * 8);
      mma_bf16(c[2 * jp], af, bf[0], bf[1], c[2 * jp]);
      mma_bf16(c[2 * jp + 1], af, bf[2], bf[3], c[2 * jp + 1]);
    }
  }
}

template <int KS>
__device__ __forceinline__ void mma_c_to_a(unsigned (&a)[KS][4], const float (&c)[2 * KS][4]) {
#pragma unroll
  for (int jp = 0; jp < KS; ++jp) {
    a[jp][0] = pack_bf16(c[2 * jp][0], c[2 * jp][1]);
    a[jp][1] = pack_bf16(c[2 * jp][2], c[2 * jp][3]);
    a[jp][2] = pack_bf16(c[2 * jp + 1][0], c[2 * jp + 1][1]);
    a[jp][3] = pack_bf16(c[2 * jp + 1][2], c[2 * jp + 1][3]);
  }
}

template <int DT, int KS, int LD>
__device__ __forceinline__ void mma_rows_pv(float (&o)[DT][4], const unsigned (&pa)[KS][4], const __nv_bfloat16* v,
                                            int lane) {
  static_assert(DT % 2 == 0, "n16 pairs");
  const int mi = lane / 8;
#pragma unroll
  for (int jp = 0; jp < KS; ++jp) {
#pragma unroll
    for (int j = 0; j < DT; j += 2) {
      unsigned vb[4];  // dims j * 8 .. + 7 (vb[0], vb[1]) and the next eight (vb[2], vb[3])
      ldmatrix_x4_trans(vb, v + (jp * 16 + (mi % 2) * 8 + lane % 8) * LD + (j + mi / 2) * 8);
      mma_bf16(o[j], pa[jp], vb[0], vb[1], o[j]);
      mma_bf16(o[j + 1], pa[jp], vb[2], vb[3], o[j + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Warpgroup products (wgmma.mma_async, sm_90a): four warps multiply a 64-row tile;
// B comes from shared memory through a 64-bit descriptor, A from shared memory or
// from registers (the mma.sync A-fragment layout, warp w of the group holding rows
// 16 w .. 16 w + 15), and the fp32 result stays in registers in the mma.sync
// C-fragment layout per warp. The products run asynchronously: fence before the
// first one that reads registers other code wrote, commit, wait, and only then touch
// the result (fm_pin keeps the compiler from moving such code above the wait).
// ---------------------------------------------------------------------------
// No-swizzle descriptor: start address, leading and stride byte offsets, each >> 4.
// K-major operand (rows of 16-byte vectors along k): leading = between the two core
// matrices of a k16 step, stride = between 8-row groups. MN-major operand (v as B:
// vectors run along n, rows are keys): leading = between 8-key groups, stride =
// between the core matrices along n.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int leading_bytes, int stride_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(leading_bytes >> 4) << 16) | (static_cast<uint64_t>(stride_bytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// make shared memory written by this thread (st.shared, completed cp.async) visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void fm_pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

__device__ __forceinline__ void fm_pin(unsigned (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

// d (64 x 64 fp32) = a (64 x 16 bf16) * b (16 x 64 bf16), both shared memory and K-major, + d if scale_d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 80 fp32) = a (64 x 16 bf16, registers) * b (16 x 80 bf16, shared memory, MN-major) + d
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[10][4], const unsigned (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// d (64 x 128 fp32) = a (64 x 16 bf16, registers) * b (16 x 128 bf16, shared memory, MN-major) + d
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const unsigned (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// the second product's wrapper for head dim D
template <int DT>
__device__ __forceinline__ void wgmma_pv(float (&o)[DT][4], const unsigned (&a)[4], uint64_t desc_v) {
  if constexpr (DT == 10) wgmma_rs_n80(o, a, desc_v);
  if constexpr (DT == 16) wgmma_rs_n128(o, a, desc_v);
}

template <int D, typename KT, typename Policy, int DV = D>
__device__ __forceinline__ void flash_mma_block(Policy& pol, unsigned char* smem, float scale) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr bool WG = fm_wgmma<D>() && DV == D;
  using L = FmLayout<D, WG>;
  using LV = FmLayout<DV, WG>;       // the value tile's
  constexpr int VPR = D / 8;          // 16-byte vectors per bf16 row
  constexpr int NT = FM_BKV / 8;      // n8 tiles of the logits
  constexpr int DT = DV / 8;          // n8 tiles of the output
  constexpr int HALF = FM_BKV * L::row_elems;  // bf16 elements of a k tile; the v tile follows it
  constexpr int TILE = HALF + FM_BKV * LV::row_elems;
  constexpr int RAW = 2 * FM_BKV * D;  // bytes of a raw int8 k tile and v tile
  static_assert(D % 16 == 0 && DV % 16 == 0 && FM_BKV % 16 == 0 && FM_STAGES >= 2, "tile shapes");
  static_assert(!QUANT || DV == D, "int8 k/v share one width");

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* tiles = qs + FM_ROWS * L::row_elems;  // FM_STAGES bf16 tiles, or one for int8 K/V
  int8_t* raw = reinterpret_cast<int8_t*>(tiles + (QUANT ? 1 : FM_STAGES) * TILE);
  int* aux_ring = reinterpret_cast<int*>(raw + (QUANT ? FM_STAGES * RAW : 0));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int lo = pol.lo, hi = pol.hi;
  const int ntiles = (max(hi - lo, 0) + FM_BKV - 1) / FM_BKV;

  // tile i into stage i % FM_STAGES; one group per call, empty past the last tile
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      const int st = i % FM_STAGES;
      const int t0 = lo + i * FM_BKV;
      if constexpr (!QUANT) {
        __nv_bfloat16* kd = tiles + st * TILE;
        __nv_bfloat16* vd = kd + HALF;
        for (int e = tid; e < FM_BKV * VPR; e += FM_THREADS) {
          int row, vec;
          L::chunk(e, row, vec);
          const bool ok = t0 + row < hi;
          const int t = ok ? t0 + row : lo;
          cp_async16_z<Policy::kCopiesThroughL1>(kd + L::off(row, vec), pol.k_row(t) + vec * 8, ok);
          if constexpr (DV == D)
            cp_async16_z<Policy::kCopiesThroughL1>(vd + L::off(row, vec), pol.v_row(t) + vec * 8, ok);
        }
        if constexpr (DV != D) {  // the narrower value rows
          for (int e = tid; e < FM_BKV * (DV / 8); e += FM_THREADS) {
            int row, vec;
            LV::chunk(e, row, vec);
            const bool ok = t0 + row < hi;
            const int t = ok ? t0 + row : lo;
            cp_async16_z<Policy::kCopiesThroughL1>(vd + LV::off(row, vec), pol.v_row(t) + vec * 8, ok);
          }
        }
      } else {
        constexpr int VPQ = D / 16;  // 16-byte vectors per int8 row
        int8_t* kd = raw + st * RAW;
        int8_t* vd = kd + FM_BKV * D;
        for (int e = tid; e < FM_BKV * VPQ; e += FM_THREADS) {
          const int row = e / VPQ, vec = e % VPQ;
          const bool ok = t0 + row < hi;
          const int t = ok ? t0 + row : lo;
          cp_async16_z<Policy::kCopiesThroughL1>(kd + row * D + vec * 16, pol.k_row(t) + vec * 16, ok);
          cp_async16_z<Policy::kCopiesThroughL1>(vd + row * D + vec * 16, pol.v_row(t) + vec * 16, ok);
        }
      }
      pol.load_aux(aux_ring + st * 2 * FM_BKV, t0, tid);
    }
    cp_async_commit();
  };

  // the block's query rows ride with tile 0's group
  for (int e = tid; e < FM_ROWS * VPR; e += FM_THREADS) {
    int row, vec;
    L::chunk(e, row, vec);
    const __nv_bfloat16* src = pol.q_row(row);
    cp_async16_z<Policy::kCopiesThroughL1>(qs + L::off(row, vec), src != nullptr ? src + vec * 8 : pol.q_row_any(), src != nullptr);
  }
#pragma unroll
  for (int i = 0; i < FM_STAGES - 1; ++i) load_tile(i);

  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;  // this thread's two rows
  pol.set_rows(r_lo, r_hi);
  float m[2] = {NEG_INF, NEG_INF};  // running max of the raw logits, rows r_lo and r_hi
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<FM_STAGES - 2>();
    if constexpr (WG) fence_async_smem();
    __syncthreads();  // tile i has arrived for every thread, and tile i - 1 is consumed
    load_tile(i + FM_STAGES - 1);  // into the stage tile i - 1 left
    const int st = i % FM_STAGES;
    const int t0 = lo + i * FM_BKV;
    const int* aux = aux_ring + st * 2 * FM_BKV;
    const __nv_bfloat16* kt = tiles + (QUANT ? 0 : st) * TILE;
    const __nv_bfloat16* vt = kt + HALF;
    if constexpr (QUANT) {  // widen the raw tile to bf16: 16 values per step
      const int8_t* src = raw + st * RAW;
      constexpr int VPQ = D / 16;
      for (int e = tid; e < 2 * FM_BKV * VPQ; e += FM_THREADS) {
        const int row = e / VPQ, vec = e % VPQ;  // rows 0..FM_BKV-1 are k, then v
        const uint4 in = *reinterpret_cast<const uint4*>(src + row * D + vec * 16);
        const int8_t* b = reinterpret_cast<const int8_t*>(&in);
        unsigned w[8];
#pragma unroll
        for (int x = 0; x < 8; ++x)
          w[x] = pack_bf16(static_cast<float>(b[2 * x]), static_cast<float>(b[2 * x + 1]));
        __nv_bfloat16* half = tiles + (row / FM_BKV) * HALF;
        *reinterpret_cast<uint4*>(half + L::off(row % FM_BKV, 2 * vec)) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(half + L::off(row % FM_BKV, 2 * vec + 1)) = make_uint4(w[4], w[5], w[6], w[7]);
      }
      if constexpr (WG) fence_async_smem();
      __syncthreads();
    }

    // logits: this warp's 16 rows against the tile's keys
    float c[NT][4];
    if constexpr (WG) {
      // q and k are K-major: 128 bytes between the two core matrices of a k16 step,
      // 16 D bytes between 8-row groups; a k16 step moves both 256 bytes on
      const uint64_t dq = wgmma_desc(qs + (warp / 4) * 64 * D, 128, 16 * D);
      const uint64_t dk = wgmma_desc(kt, 128, 16 * D);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(c, dq + kk * 16, dk + kk * 16, kk > 0);
      wgmma_commit();
      wgmma_wait();
      fm_pin(c);
    } else {
      mma_rows_abt<D, NT, L::LD>(c, qs + warp * 16 * L::LD, kt, lane);
    }

    // int8 key scales on the raw logits; mask where the tile needs it
    const float* ksc = reinterpret_cast<const float*>(aux);
    const float* vsc = ksc + FM_BKV;
    if constexpr (QUANT) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float k0 = ksc[j * 8 + 2 * t4], k1 = ksc[j * 8 + 2 * t4 + 1];
        c[j][0] *= k0;
        c[j][1] *= k1;
        c[j][2] *= k0;
        c[j][3] *= k1;
      }
    }
    if (pol.needs_mask(aux, t0)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t4 + (e & 1);
          if (!pol.live(e >> 1, aux, col, t0 + col)) c[j][e] = NEG_INF;
        }
      }
    }

    // online softmax on the fragments; c becomes p. m is kept on the raw logits
    // (scale > 0, so their max is the scaled logits' max), and each weight is one
    // fused multiply-add and one ex2: p = 2^(c * scale - m * scale).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx0 = NEG_INF, mx1 = NEG_INF;  // two chains, half the dependent depth
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        mx0 = fmaxf(mx0, fmaxf(c[j][2 * h], c[j][2 * h + 1]));
        mx1 = fmaxf(mx1, fmaxf(c[j + 1][2 * h], c[j + 1][2 * h + 1]));
      }
      float mx = fmaxf(mx0, mx1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float ref = is_live(m_new) ? m_new * scale : 0.f;
      const float alpha = fast_exp2((m[h] - m_new) * scale);
      m[h] = m_new;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        c[j][2 * h] = fast_exp2(fmaf(c[j][2 * h], scale, -ref));
        c[j][2 * h + 1] = fast_exp2(fmaf(c[j][2 * h + 1], scale, -ref));
        c[j + 1][2 * h] = fast_exp2(fmaf(c[j + 1][2 * h], scale, -ref));
        c[j + 1][2 * h + 1] = fast_exp2(fmaf(c[j + 1][2 * h + 1], scale, -ref));
        sum0 += c[j][2 * h] + c[j][2 * h + 1];
        sum1 += c[j + 1][2 * h] + c[j + 1][2 * h + 1];
      }
      l[h] = l[h] * alpha + (sum0 + sum1);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }

    // O += P V: 16 keys per step, P's A fragment straight from c
    unsigned pa[NT / 2][4];
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if constexpr (QUANT) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float v0 = vsc[(2 * jp + x) * 8 + 2 * t4], v1 = vsc[(2 * jp + x) * 8 + 2 * t4 + 1];
          c[2 * jp + x][0] *= v0;
          c[2 * jp + x][1] *= v1;
          c[2 * jp + x][2] *= v0;
          c[2 * jp + x][3] *= v1;
        }
      }
      pa[jp][0] = pack_bf16(c[2 * jp][0], c[2 * jp][1]);
      pa[jp][1] = pack_bf16(c[2 * jp][2], c[2 * jp][3]);
      pa[jp][2] = pack_bf16(c[2 * jp + 1][0], c[2 * jp + 1][1]);
      pa[jp][3] = pack_bf16(c[2 * jp + 1][2], c[2 * jp + 1][3]);
    }
    if constexpr (WG) {
      // v as B is MN-major: 16 D bytes between 8-key groups (the leading offset here),
      // 128 bytes between the core matrices along d; 16 keys on are 32 D bytes on
      const uint64_t dv = wgmma_desc(vt, 16 * D, 128);
      wgmma_fence();
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) wgmma_pv<DT>(o, pa[jp], dv + jp * (2 * D));
      wgmma_commit();
      wgmma_wait();
      fm_pin(o);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) fm_pin(pa[jp]);  // P's registers were read until the wait
    } else {
      mma_rows_pv<DT, NT / 2, LV::LD>(o, pa, vt, lane);
    }
  }
  cp_async_wait<0>();  // q, when the range was empty; no copy outlives the block

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    // the row's log-sum-exp of the scaled logits, natural log (the backward's input):
    // log2 of sum 2^(c scale) is m scale + log2(sum); no live key: NEG_INF
    float* lp = pol.lse_row(h == 0 ? r_lo : r_hi);
    if (lp != nullptr && t4 == 0) *lp = sum > 0.f ? (m[h] * scale + log2f(sum)) * LN2 : NEG_INF;
    __nv_bfloat16* op = pol.out_row(h == 0 ? r_lo : r_hi);
    if (op != nullptr) {
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<unsigned*>(op + j * 8 + 2 * t4) = pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    }
  }
}

// Raise a kernel's dynamic shared-memory limit once (above 48 KB it must be asked for).
template <typename Kernel>
int fm_allow_smem(Kernel kernel, int bytes) {
  if (bytes <= (48 << 10)) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace zt
