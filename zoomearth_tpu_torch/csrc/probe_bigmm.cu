// P2: decode attention as one big product per key tile, hand-written for Hopper.
//
// Replaces scripts/probe_attn.py::bigmm_decode_attention (Pallas, pallas_call at
// :155, body _bigmm_kernel at :65).
//
// Semantics: single-token GQA decode attention, q (B, H, D) against (B, Hkv, T, D)
// bf16 caches. Rows go in blocks of RB (the largest of 4, 2, 1 dividing B); the N =
// RB * Hkv (row, kv head) pairs of a row block walk the key axis up to ncb * chunk,
// ncb being the largest per-row count max(ceil(kv_len / chunk), 1) of the block;
// later keys are skipped. Per key tile, one product of all N query groups against
// the tile's keys is taken and only the diagonal blocks (each pair's keys against
// its own queries) are kept, masked by kv_len, and fed to an fp32 online softmax;
// then the block-diagonal P (bf16, as the reference casts it) multiplies v. A row
// with kv_len = 0 sees every logit masked to the same -1e30 and returns the mean of
// v over the ncb * chunk slots its row block walks, as the Pallas kernel does.
// Needs T % chunk == 0 (the reference silently drops the tail; the wrapper raises),
// G = 8, D = 128, N <= 8.
//
// What bounds it on the card: bytes in flight, as for K3. The first version ran one
// block per row block (B / RB = 8 blocks at the probe's B = 32, the TPU grid's
// chunk axis a loop inside the block), and each warp loaded its 16-key tile, waited,
// and only then ran the product: no load was in flight while the mma ran. The
// N / 2 = 4x of extra multiplies is not the bound (~40 flop per cache byte against
// the tensor cores' ~295).
//
// What the design does about it:
// - The key axis is split across blocks: the grid is (B / RB) x ceil(T / split),
//   each block taking `split` keys (a multiple of 16) of every pair of its row
//   block; 192 blocks at the probe's shapes with split = 64. A block at or past
//   ncb * chunk exits at once. Each leaves per-pair softmax states, which the shared
//   split merge (split_merge.cu) combines: one C call, two launches.
// - Warp n owns pair n and double-buffers its 16-key tiles of k and v in shared
//   memory with 16-byte cp.async copies: the next tile is in flight while the
//   current tile's products run.
// - The products are what the probe measures: the tile's keys against every
//   16-row tile of the block's N * G query rows on the tensor cores (mma.sync
//   m16n8k16, bf16 in, fp32 accumulate), of which the warp keeps the half tile that
//   holds its own pair's queries; P @ V is an mma over the diagonal block only, with
//   the other pair's half of the 16-row tile zero. The fragment helpers are
//   common.cuh's, shared with K1/K2's flash core.
#include "common.cuh"

namespace zt {

constexpr int BIG_G = 8;    // query heads per kv head: one n8 tile per pair
constexpr int BIG_D = 128;  // head dim
constexpr int BIG_MAXN = 8; // pairs per row block (warps per block)
constexpr int BIG_KT = 16;  // keys per staged tile (the mma's k)
constexpr int BIG_LD = BIG_D + 8;  // padded shared-memory row (conflict-free ldmatrix)
constexpr int BIG_TILE = 2 * BIG_KT * BIG_LD;  // one stage of a warp: k tile, then v tile

// q (B, H, D) contiguous; k/v (B, Hkv, T, D) contiguous; kv_len (B,) clipped to
// [0, T]; ncb (B / RB,) chunks each row block walks; part the split scratch
// (SplitPartials, pairs = B * Hkv, nsplit = gridDim.y, G = 8).
// Dynamic shared memory: the block's query rows padded to MT * 16, then per warp two
// stages of a k tile and a v tile.
__global__ void __launch_bounds__(BIG_MAXN * 32)
    bigmm_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
                       const int* __restrict__ ncb, float* __restrict__ part, int Hkv, int T,
                       int RB, int chunk, int split, float scale) {
  const int bb = blockIdx.x, s = blockIdx.y;
  const int walk = ncb[bb] * chunk;
  const int key_lo = s * split;
  if (key_lo >= walk) return;
  const int ntiles = (min(key_lo + split, walk) - key_lo) / BIG_KT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int N = RB * Hkv;
  const int MT = (N + 1) / 2;  // 16-row query tiles
  const int H = Hkv * BIG_G;
  const int n = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int half = n % 2, own = n / 2;  // this pair's rows: half `half` of query tile `own`
  const int r = n / Hkv, kh = n % Hkv;
  const int b = bb * RB + r;
  const int len = kv_len[b];

  __nv_bfloat16* qs = smem;
  __nv_bfloat16* ring = qs + MT * 16 * BIG_LD + n * 2 * BIG_TILE;  // this warp's two stages

  constexpr int VPR = BIG_D / 8;  // 16-byte vectors per row
  const long long base = ((long long)b * Hkv + kh) * T * BIG_D;
  const __nv_bfloat16* kg = k + base;
  const __nv_bfloat16* vg = v + base;
  // tile i (keys key_lo + 16 i ..) into stage i % 2; one group per call, empty past the end
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      __nv_bfloat16* ks = ring + (i % 2) * BIG_TILE;
      __nv_bfloat16* vs = ks + BIG_KT * BIG_LD;
      const int key0 = key_lo + i * BIG_KT;
#pragma unroll
      for (int u = 0; u < BIG_KT * VPR / 32; ++u) {
        const int e = lane + 32 * u;
        const int row = e / VPR, vec = e % VPR;
        const long long o = (long long)(key0 + row) * BIG_D + vec * 8;
        cp_async16(ks + row * BIG_LD + vec * 8, kg + o);
        cp_async16(vs + row * BIG_LD + vec * 8, vg + o);
      }
    }
    cp_async_commit();
  };
  load_tile(0);

  // the block's N * G query rows are contiguous in q; pad rows are zero
  const uint4* qsrc = reinterpret_cast<const uint4*>(q + (long long)bb * RB * H * BIG_D);
  for (int i = threadIdx.x; i < MT * 16 * VPR; i += blockDim.x) {
    const int row = i / VPR, vec = i % VPR;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < N * BIG_G) val = qsrc[i];
    *reinterpret_cast<uint4*>(qs + row * BIG_LD + vec * 8) = val;
  }
  __syncthreads();

  float m = NEG_INF, l = 0.f;  // softmax state of query row g of this pair
  float acc[BIG_D / 8][2];     // its output columns j * 8 + 2t + {0, 1}
#pragma unroll
  for (int j = 0; j < BIG_D / 8; ++j) acc[j][0] = acc[j][1] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    load_tile(i + 1);  // into the stage tile i - 1 left, which the warp is done with
    cp_async_wait<1>();
    __syncwarp();
    const __nv_bfloat16* ks = ring + (i % 2) * BIG_TILE;
    const __nv_bfloat16* vs = ks + BIG_KT * BIG_LD;
    const int key0 = key_lo + i * BIG_KT;

    // k as the product's B operand (d x keys), both 8-key halves, every 16-d step
    unsigned kb[BIG_D / 16][4];
#pragma unroll
    for (int st = 0; st < BIG_D / 16; ++st) {
      const int mi = lane / 8;
      ldmatrix_x4(kb[st], ks + ((mi / 2) * 8 + lane % 8) * BIG_LD + st * 16 + (mi % 2) * 8);
    }
    // the big product: every 16-row query tile against these 16 keys; keep our tile
    float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
    for (int mt = 0; mt < MT; ++mt) {
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int st = 0; st < BIG_D / 16; ++st) {
        unsigned a[4];
        ldmatrix_x4(a, qs + (mt * 16 + lane % 16) * BIG_LD + st * 16 + (lane / 16) * 8);
        mma_bf16(c0, a, kb[st][0], kb[st][1], c0);
        mma_bf16(c1, a, kb[st][2], kb[st][3], c1);
      }
      if (mt == own) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] = c0[e];
          hi[e] = c1[e];
        }
      }
    }
    // the diagonal block: query row g of this pair against keys 2t, 2t+1, 8+2t, 9+2t
    float sc[4] = {lo[2 * half], lo[2 * half + 1], hi[2 * half], hi[2 * half + 1]};
    const int kpos[4] = {key0 + 2 * t, key0 + 2 * t + 1, key0 + 8 + 2 * t, key0 + 9 + 2 * t};
    float mx = NEG_INF;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[e] = kpos[e] < len ? sc[e] * scale : NEG_INF;
      mx = fmaxf(mx, sc[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float p[4], ps = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = expf(sc[e] - m_new);
      ps += p[e];
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * alpha + ps;
    m = m_new;

    // block-diagonal P @ V: P's other half rows are zero
    const unsigned p01 = pack_bf16(p[0], p[1]), p23 = pack_bf16(p[2], p[3]);
    const unsigned a[4] = {half ? 0u : p01, half ? p01 : 0u, half ? 0u : p23, half ? p23 : 0u};
#pragma unroll
    for (int j = 0; j < BIG_D / 8; j += 2) {
      unsigned vb[4];
      const int mi = lane / 8;
      ldmatrix_x4_trans(vb, vs + ((mi % 2) * 8 + lane % 8) * BIG_LD + (j + mi / 2) * 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float cin[4] = {0.f, 0.f, 0.f, 0.f};
        cin[2 * half] = acc[j + jj][0] * alpha;
        cin[2 * half + 1] = acc[j + jj][1] * alpha;
        float d[4];
        mma_bf16(d, a, vb[2 * jj], vb[2 * jj + 1], cin);
        acc[j + jj][0] = d[2 * half];
        acc[j + jj][1] = d[2 * half + 1];
      }
    }
    __syncwarp();  // every lane is done with this stage before the next load refills it
  }

  const SplitPartials P = split_partials(part, gridDim.x * N, gridDim.y, BIG_G, BIG_D);
  const long long row = ((long long)(bb * N + n) * gridDim.y + s) * BIG_G + g;
  if (t == 0) {
    P.m[row] = m;
    P.l[row] = l;
  }
#pragma unroll
  for (int j = 0; j < BIG_D / 8; ++j)
    *reinterpret_cast<float2*>(P.acc + row * BIG_D + j * 8 + 2 * t) = make_float2(acc[j][0], acc[j][1]);
}

}  // namespace zt

// q (B, H, D), k/v (B, Hkv, T, D) bf16, contiguous and 16-byte aligned; kv_len (B,)
// int32 clipped to [0, T]; ncb (B / RB,) int32; part the fp32 split scratch of
// B * Hkv * ceil(T / split) * 8 * (128 + 2) values; out (B, H, D) bf16.
extern "C" int zt_probe_bigmm(const void* q, const void* k, const void* v, const int* kv_len,
                              const int* ncb, void* part, void* out, int B, int H, int Hkv, int T,
                              int D, int RB, int chunk, int split, float scale, void* stream) {
  using namespace zt;
  cudaGetLastError();
  if (Hkv <= 0 || H != Hkv * BIG_G || D != BIG_D || RB <= 0 || B % RB != 0 ||
      RB * Hkv > BIG_MAXN || chunk <= 0 || chunk % BIG_KT != 0 || T % chunk != 0 || split <= 0 ||
      split % BIG_KT != 0)
    return ZT_UNSUPPORTED;
  const int N = RB * Hkv;
  const int nsplit = (T + split - 1) / split;
  const int smem = ((N + 1) / 2 * 16 * BIG_LD + N * 2 * BIG_TILE) * 2;
  static int smem_allowed = 48 << 10;  // raised once, not per call
  cudaError_t e;
  if (smem > smem_allowed) {
    e = cudaFuncSetAttribute(bigmm_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  bigmm_split_kernel<<<dim3(B / RB, nsplit), N * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len, ncb, pt, Hkv, T, RB, chunk, split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_split_merge(pt, ncb, N, chunk, 0, split, nsplit, out, BF16, B * Hkv, BIG_G, BIG_D, st);
}
