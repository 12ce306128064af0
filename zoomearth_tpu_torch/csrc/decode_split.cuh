// The split pass of single-token GQA decode attention, shared by K3 (flash_decode.cu:
// the slot cache) and K4 (paged_decode.cu: a paged pool). The two kernels compute one
// function and differ only in where slot t of row b lives, so each instantiates this
// pass with an address policy and nothing else.
//
// What bounds it on the card: bytes, and how many of them are in flight. Each cache
// byte serves G = 8 query heads with one multiply-add each (~8 flop per byte, far
// below the tensor cores' ~295), so only the rate at which k/v arrive matters. At
// B = 8 and Hkv = 2 the decode has 16 (row, kv head) pairs: one block per pair with
// one row load in flight per warp, as the first version had, fills 16 of 132 SMs
// and keeps ~64 KB in flight across the card (~11-15 GB/s measured). Once the bytes
// flow, the next bound is shared memory: every staged byte is read by the threads
// of each query head that uses it. At B = 32-64 with a third of T = 4096 live, builds
// with phases left out (NVIDIA H100 80GB HBM3, 700 W; PERF.md) show the ring
// first: copies and barriers alone take two thirds of the time (1.3-1.6 TB/s of live
// cache, against the stream probe's 1.75 TB/s for as many bytes), and the three
// phases, in series behind a barrier each, the rest.
//
// What the design does about it:
// - The key axis is split across blocks: the grid is (B * Hkv) x nsplit, with the
//   split length chosen on the host from the shapes alone (ops/flash_decode.py::
//   split_plan) so that a small batch still puts several blocks on every SM. A
//   block whose split starts at or past its row's live length exits at once; cache
//   reads scale with the live slots, not with T.
// - Each block streams its split through a ring of K3_STAGES shared-memory stages
//   of K3_TILE slots of k and v (and, for int8, their scales), filled by cp.async
//   copies, so two tiles (34 KB of bf16 k/v at D = 128) are in flight while one is
//   computed. The policy gives each copied row its address, so a tile may cross
//   pages: the page is looked up per row, never per tile.
// - The math is fp32 FMA from the staged tiles, with no per-slot chain of shuffles,
//   in three phases per tile. Logits: lane t of warp (h, q) takes slot t against
//   the four query heads 4h .. 4h + 3 over a quarter of the row (its 16-byte vectors
//   q, q + 4, ...), so each staged k byte is read twice, not G times. Softmax: warp
//   g sums head g's four quarters per slot and takes the tile's online-softmax step
//   (one max and one sum across the warp). p @ v: lane j of warp (h, q) accumulates
//   dims 4j .. 4j + 3 of heads 4h .. 4h + 3 over the slots q, q + 4, ...; the four
//   slot quarters are summed once, at the end of the split.
// - Each block leaves its softmax state per head (m, l, acc) in scratch, and the
//   shared split merge (split_merge.cu) combines them: one C call, two launches.
//
// An address policy is a struct passed to the kernel by value with
// - `static constexpr bool DEAD_READS_ALL`: what a row with no live slot does. true
//   (K3): it is read as T slots with equal logits, which gives the mean of v (the
//   decoder's answer); the merge is passed dead_len = T. false (K4): its blocks exit
//   before any read, its scratch stays unwritten and the merge, passed dead_len = 0,
//   writes 0 (the Pallas K4's answer).
// - `rows(b, kh)`: the (row, kv head) pair's view, whose `k(t)` and `v(t)` are the
//   byte addresses of slot t's k and v rows (D contiguous elements, 16-byte aligned).
//   The pass calls them only for t < kv_len[b], so a paged policy never reads a
//   block-table entry past the row's pages.
#pragma once

#include "common.cuh"

namespace zt {

constexpr int K3_MAXG = 8;       // query heads per kv head: one per warp in the softmax phase
constexpr int K3_THREADS = 32 * K3_MAXG;
constexpr int K3_TILE = 32;      // slots per staged tile: one per lane in the logit and softmax phases
constexpr int K3_STAGES = 3;     // ring depth: K3_STAGES - 1 tiles in flight
constexpr int K3_HPT = 4;        // query heads per thread in the logit and p @ v phases
constexpr int K3_PARTS = K3_THREADS / 32 / (K3_MAXG / K3_HPT);  // row quarters (logits), slot quarters (p @ v)

// One 16-byte vector of cache elements from shared memory as floats.
__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load_vec(const int8_t* p, float (&f)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
}

// 4 consecutive cache elements (16-, 8- or 4-byte aligned) as floats.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) { load_vec(p, f); }

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

__device__ __forceinline__ void load4(const int8_t* p, float (&f)[4]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = static_cast<float>(c[i]);
}

// Shared memory of one block: the ring (K3_STAGES x [k tile, v tile, int8: k and v
// scales], rows padded by 16 bytes so that a warp's 16-byte reads of 32 rows hit
// distinct banks), then the scaled queries [K3_MAXG][D], the logit quarters
// [K3_PARTS][K3_MAXG][K3_TILE], p [K3_TILE][K3_MAXG] and each head's rescale factor.
// After the last tile the ring holds the p @ v quarters [K3_PARTS][K3_MAXG][D].
__host__ __device__ __forceinline__ int k3_row_bytes(int D, int itemsize) { return D * itemsize + 16; }

__host__ __device__ __forceinline__ int k3_stage_bytes(int D, int itemsize) {
  return 2 * K3_TILE * k3_row_bytes(D, itemsize) + (itemsize == 1 ? 2 * K3_TILE * (int)sizeof(float) : 0);
}

__host__ __device__ __forceinline__ size_t k3_smem_bytes(int D, int itemsize) {
  return (size_t)K3_STAGES * k3_stage_bytes(D, itemsize) +
         sizeof(float) * ((size_t)K3_MAXG * D + K3_PARTS * K3_MAXG * K3_TILE + K3_TILE * K3_MAXG + K3_MAXG);
}

// q (B, H, D) through q_sb, q_sh; kv_len (B,) int32; ksc/vsc the int8 per-token
// scales (B, Hkv, T) through sc_sb, sc_sh with unit stride on T (null otherwise);
// part the split scratch (SplitPartials). T is the slots a row can hold.
template <typename QT, typename KT, typename Policy>
__global__ void __launch_bounds__(K3_THREADS, 3)
    decode_split_kernel(const Policy policy, const QT* __restrict__ q, const float* __restrict__ ksc,
                        const float* __restrict__ vsc, const int* __restrict__ kv_len,
                        float* __restrict__ part, int Hkv, int T, int D, int G, int split_len,
                        long long q_sb, long long q_sh, long long sc_sb, long long sc_sh, float scale) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int VEC = 16 / sizeof(KT);  // cache elements per 16-byte vector
  const int pair = blockIdx.x, split = blockIdx.y;
  const int b = pair / Hkv, kh = pair % Hkv;
  const int klen = min(kv_len[b], T);
  if (!Policy::DEAD_READS_ALL && klen <= 0) return;  // no live slot: nothing read, the merge writes 0
  const bool dead = Policy::DEAD_READS_ALL && klen <= 0;  // no live slot: T slots with equal logits
  const int live = dead ? T : klen;
  const int lo = split * split_len;
  if (lo >= live) return;
  const int hi = min(lo + split_len, live);
  const int ntiles = (hi - lo + K3_TILE - 1) / K3_TILE;

  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = k3_row_bytes(D, sizeof(KT));
  const int stage_bytes = k3_stage_bytes(D, sizeof(KT));
  float* qs = reinterpret_cast<float*>(smem + (size_t)K3_STAGES * stage_bytes);
  float* lg = qs + K3_MAXG * D;                   // logit quarters
  float* ps = lg + K3_PARTS * K3_MAXG * K3_TILE;  // p (times v's int8 scale)
  float* alphas = ps + K3_TILE * K3_MAXG;

  const auto rows = policy.rows(b, kh);
  const long long sc_base = (long long)b * sc_sb + (long long)kh * sc_sh;
  const int cpr = D * (int)sizeof(KT) / 16;  // 16-byte vectors per row

  // Tile i: slots lo + i * K3_TILE .. (at most K3_TILE, never past hi) into stage
  // i % K3_STAGES. Every call commits one group, empty past the last tile, so the
  // wait below counts groups alike in every iteration.
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      unsigned char* dst = smem + (size_t)(i % K3_STAGES) * stage_bytes;
      const int t0 = lo + i * K3_TILE;
      const int n = min(K3_TILE, hi - t0);
      const int per = n * cpr;
      for (int c = threadIdx.x; c < 2 * per; c += K3_THREADS) {
        const int which = c >= per;  // 0: k, 1: v
        const int cc = which ? c - per : c;
        const int r = cc / cpr, off = (cc - r * cpr) * 16;
        const char* src = which ? rows.v(t0 + r) + off : rows.k(t0 + r) + off;
        cp_async16(dst + which * K3_TILE * rs + r * rs + off, src);
      }
      if constexpr (QUANT) {
        float* sd = reinterpret_cast<float*>(dst + 2 * K3_TILE * rs);
        for (int c = threadIdx.x; c < 2 * n; c += K3_THREADS) {
          const int which = c >= n;
          const int r = which ? c - n : c;
          cp_async4(sd + which * K3_TILE + r, (which ? vsc : ksc) + sc_base + t0 + r);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < K3_STAGES - 1; ++i) load_tile(i);

  const QT* qb = q + (long long)b * q_sb + (long long)(kh * G) * q_sh;
  for (int i = threadIdx.x; i < K3_MAXG * D; i += K3_THREADS) {
    const int g = i / D;
    qs[i] = g < G ? to_f(qb[(long long)g * q_sh + (i - g * D)]) * scale : 0.f;
  }
  for (int i = threadIdx.x; i < K3_TILE * K3_MAXG + K3_MAXG; i += K3_THREADS) ps[i] = 0.f;  // and alphas

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = (warp % (K3_MAXG / K3_HPT)) * K3_HPT;  // heads h0 .. h0 + 3 (logits, p @ v)
  const int quarter = warp / (K3_MAXG / K3_HPT);        // row quarter (logits), slot quarter (p @ v)
  const bool heads = h0 < G;                            // warp-uniform
  const int nv = D / 4;
  const bool vown = heads && lane < nv;  // p @ v: dims 4 lane .. 4 lane + 3
  float m = NEG_INF, l = 0.f;           // softmax state of head `warp`
  float acc[K3_HPT][4] = {};

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<K3_STAGES - 2>();
    __syncthreads();  // tile i is in; every thread is done with tile i - 1's stage and p
    load_tile(i + K3_STAGES - 1);
    const unsigned char* kt = smem + (size_t)(i % K3_STAGES) * stage_bytes;
    const unsigned char* vt = kt + K3_TILE * rs;
    const float* sct = reinterpret_cast<const float*>(vt + K3_TILE * rs);  // int8: k scales, v scales
    const int n = min(K3_TILE, hi - lo - i * K3_TILE);

    // logits: lane = slot, four heads, the row's 16-byte vectors quarter, quarter + 4, ...
    if (heads && !dead) {  // warp-uniform
      float s[K3_HPT] = {};
      if (lane < n) {
        const KT* kr = reinterpret_cast<const KT*>(kt + lane * rs);
#pragma unroll 2
        for (int c = quarter; c < cpr; c += K3_PARTS) {
          float kk[VEC];
          load_vec(kr + c * VEC, kk);
#pragma unroll
          for (int h = 0; h < K3_HPT; ++h) {
            const float* qh = qs + (h0 + h) * D + c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qh + e);
              s[h] = fmaf(qq.x, kk[e], s[h]);
              s[h] = fmaf(qq.y, kk[e + 1], s[h]);
              s[h] = fmaf(qq.z, kk[e + 2], s[h]);
              s[h] = fmaf(qq.w, kk[e + 3], s[h]);
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < K3_HPT; ++h) lg[(quarter * K3_MAXG + h0 + h) * K3_TILE + lane] = s[h];
    }
    __syncthreads();

    // softmax: warp = head, lane = slot; the tile's online-softmax step (one max and
    // one sum across the warp)
    if (warp < G) {  // warp-uniform
      float s = NEG_INF, vscale = 1.f;
      if (lane < n) {
        s = 0.f;
        if (!dead) {
#pragma unroll
          for (int p = 0; p < K3_PARTS; ++p) s += lg[(p * K3_MAXG + warp) * K3_TILE + lane];
          if constexpr (QUANT) s *= sct[lane];
        }
        if constexpr (QUANT) vscale = sct[K3_TILE + lane];
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = expf(m - m_new);
      const float p = lane < n ? expf(s - m_new) : 0.f;
      l = fmaf(l, alpha, warp_sum(p));
      m = m_new;
      ps[lane * K3_MAXG + warp] = p * vscale;
      if (lane == 0) alphas[warp] = alpha;
    }
    __syncthreads();

    // p @ v: lane = dims 4 lane .., four heads, the tile's slots quarter, quarter + 4, ...
    if (vown) {
      const float4 al = *reinterpret_cast<const float4*>(alphas + h0);
      const float a4[K3_HPT] = {al.x, al.y, al.z, al.w};
#pragma unroll
      for (int h = 0; h < K3_HPT; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][e] *= a4[h];
      const KT* vc = reinterpret_cast<const KT*>(vt) + 4 * lane;
#pragma unroll 2
      for (int t = quarter; t < n; t += K3_PARTS) {
        float vv[4];
        load4(reinterpret_cast<const KT*>(reinterpret_cast<const unsigned char*>(vc) + t * rs), vv);
        const float4 pp = *reinterpret_cast<const float4*>(ps + t * K3_MAXG + h0);
        const float p4[K3_HPT] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int h = 0; h < K3_HPT; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(p4[h], vv[e], acc[h][e]);
      }
    }
  }

  // sum the slot quarters of p @ v through the ring (every copy has landed: the
  // groups still counted are empty)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [K3_PARTS][K3_MAXG][D]
  if (vown) {
#pragma unroll
    for (int h = 0; h < K3_HPT; ++h)
      *reinterpret_cast<float4*>(red + (quarter * K3_MAXG + h0 + h) * D + 4 * lane) =
          make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
  __syncthreads();
  const SplitPartials P = split_partials(part, gridDim.x, gridDim.y, G, D);
  const long long row = ((long long)pair * gridDim.y + split) * G;
  for (int idx = threadIdx.x; idx < G * nv; idx += K3_THREADS) {
    const int g = idx / nv, d = (idx - g * nv) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < K3_PARTS; ++p) {
      const float4 r = *reinterpret_cast<const float4*>(red + (p * K3_MAXG + g) * D + d);
      a.x += r.x, a.y += r.y, a.z += r.z, a.w += r.w;
    }
    *reinterpret_cast<float4*>(P.acc + (row + g) * D + d) = a;
  }
  if (lane == 0 && warp < G) {
    P.m[row + warp] = m;
    P.l[row + warp] = l;
  }
}

// The split pass over (B * Hkv) x nsplit blocks of split_len slots (a multiple of
// K3_TILE), then the split merge into out (B, H, D) of the dtype code out_dtype.
template <typename QT, typename KT, typename Policy>
static int launch_decode_split(const Policy& policy, const void* q, const float* ksc, const float* vsc,
                               const int* kv_len, float* part, void* out, int B, int Hkv, int T, int D,
                               int G, int split_len, int nsplit, long long q_sb, long long q_sh,
                               long long sc_sb, long long sc_sh, float scale, int out_dtype,
                               cudaStream_t stream) {
  const int smem = (int)k3_smem_bytes(D, sizeof(KT));
  static int smem_allowed = 48 << 10;  // raised once per instantiation, not per call
  cudaError_t e;
  if (smem > smem_allowed) {
    e = cudaFuncSetAttribute(decode_split_kernel<QT, KT, Policy>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  decode_split_kernel<QT, KT, Policy><<<dim3(B * Hkv, nsplit), K3_THREADS, smem, stream>>>(
      policy, static_cast<const QT*>(q), ksc, vsc, kv_len, part, Hkv, T, D, G, split_len, q_sb, q_sh,
      sc_sb, sc_sh, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_split_merge(part, kv_len, Hkv, 1, Policy::DEAD_READS_ALL ? T : 0, split_len, nsplit, out,
                            out_dtype, B * Hkv, G, D, stream);
}

// What every instantiation takes: G <= K3_MAXG query heads per kv head, D a multiple
// of 8 up to 128 whose rows are whole 16-byte vectors, and a split plan that covers T.
static inline bool decode_split_supported(int H, int Hkv, int T, int D, int itemsize, int split_len, int nsplit) {
  if (Hkv <= 0 || H % Hkv != 0 || T <= 0 || H / Hkv > K3_MAXG) return false;
  if (D <= 0 || D > 128 || D % 8 != 0 || (D * itemsize) % 16 != 0) return false;
  return split_len > 0 && split_len % K3_TILE == 0 && nsplit == (T + split_len - 1) / split_len;
}

}  // namespace zt
