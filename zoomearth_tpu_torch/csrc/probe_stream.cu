// P1: the decode KV stream probe, hand-written for Hopper.
//
// Replaces scripts/probe_attn.py::stream_only (Pallas, pallas_call at :49, body
// _stream_kernel at :25): it reads the same k/v blocks as decode attention with a
// trivial reduction, so its time is the floor that K3, K4 and P2 are held against.
//
// Semantics (the TPU probe's output): row blocks of rb rows; per row block bb and
// chunk c, the (rb, Hkv, chunk, D) k and v blocks are flattened to rows ordered
// (row, kv head, slot) and their first 64 rows summed (k + v) in fp32 over the
// chunks; out (B, Hkv, G, D) holds the first rb * Hkv * G of those 64 rows. Needs
// B % rb == 0, T % chunk == 0 and rb * Hkv * G <= min(64, rb * Hkv * chunk). Beside
// it, sums (B / rb,) holds the fp32 sum of every k and v element the row block read:
// a load whose value went nowhere would be deleted by the compiler, and the probe
// would time no reads.
//
// What bounds it on the card: bytes (one add per element read), so what matters is
// how many bytes are in flight and how little else a call does. The card moves 3.35
// TB/s and a read takes on the order of a microsecond under load, so about 3 MB, 25
// KB per SM, must be in flight before the memory rate can be met at all. Measured
// (NVIDIA H100 80GB HBM3, 700 W; scripts/decode_variants.py): each further byte costs
// what 3.1 TB/s costs (a 50 MB and a 200 MB stream on one card), and a call pays about 5 us
// beside that for launch, ramp and drain and 2.6-3.1 us for the memset, so the probe's
// 50 MB stream reaches 1.75 TB/s (2.14 when the L2 was flushed by reading instead of
// by writing: a written flush leaves modified lines that the stream must push out).
// The first version ran four device operations a call (two fills, 1536 short-lived
// blocks whose owners of the first rows made 8192 element-wise atomics each, a finish
// kernel) and took 0.0314 ms where this one takes 0.0288 (0.0275 and 0.0235 with the
// read flush). How the copies are made does not matter to the time: the bulk copies,
// the cp.async build and the __ldg build are within 4 % of each other. The bulk copies
// stay because they cost no registers and no address arithmetic in the threads that
// add.
//
// What the design does about it:
// - One launch per call (after a memset of the B / rb sums). A persistent grid of
//   P1_BLOCKS_PER_SM blocks on every SM; block g walks the contiguous run of tiles
//   [n g / blocks, n (g + 1) / blocks), so there is no last wave, and it adds into
//   sums once per row block it touches (one or two), not once per tile.
// - The k and v of a row block are contiguous, so a tile is P1_TILE bytes of each,
//   fetched by one 1-D bulk asynchronous copy each (cp.async.bulk, the TMA's copy
//   without a tensor map) into a ring of P1_STAGES shared-memory stages. One lane of
//   a producer warp starts them and an mbarrier per stage counts their bytes in; the
//   eight consumer warps wait on it (by phase parity: round r of a stage waits for
//   parity r & 1), add the stage up from shared memory and release it through a
//   second mbarrier (one arrival per warp; the producer waits for parity (r & 1) ^ 1,
//   which passes at once in round 0). A block keeps (P1_STAGES - 1) x 2 x P1_TILE
//   bytes in flight: 96 KB per SM at the defaults, four times the 25 KB above. No
//   thread spends registers or address arithmetic on the copies. The mbarrier's
//   completion makes the copied bytes visible to the consumers; the release and
//   acquire of the second mbarrier order their reads before the next copy into the
//   stage.
// - out has few owners: its rb * H rows are the same slots of every chunk, so the
//   consumer threads of the grid share its 16-byte vectors among themselves, each
//   reading its vector of every chunk straight from device memory (B * H * D * T /
//   chunk elements of k and of v: under 1 % of the stream at the probe's shape),
//   summing in fp32 and writing the output dtype: no accumulator in device memory,
//   no atomics, no finish kernel. They do it while the first copies are in flight.
// - sums is added with one atomic per block and row block, in an order that changes
//   from run to run: it is fp32 to about 1e-7 of the summed magnitudes, not bit-stable.
//
// Builds for measurement (scripts/decode_variants.py; the wrapper uses the default):
// ZT_P1_COPY 1 fills the same ring with cp.async 16-byte copies made by every
// consumer thread, 2 loads with __ldg into registers with no ring; ZT_P1_SKIP leaves
// parts out and gives wrong answers by design (1: the staged bytes are never read, 2:
// no out, 4: no memset).
#include "common.cuh"

#ifndef ZT_P1_COPY
#define ZT_P1_COPY 0
#endif
#ifndef ZT_P1_TILE
#define ZT_P1_TILE 8192
#endif
#ifndef ZT_P1_STAGES
#define ZT_P1_STAGES 4
#endif
#ifndef ZT_P1_BLOCKS_PER_SM
#define ZT_P1_BLOCKS_PER_SM 2
#endif
#ifndef ZT_P1_SKIP
#define ZT_P1_SKIP 0
#endif

namespace zt {

constexpr int P1_COPY = ZT_P1_COPY;        // 0: bulk asynchronous copies, 1: cp.async, 2: __ldg
constexpr int P1_TILE = ZT_P1_TILE;        // bytes of k and of v per tile (a multiple of 16)
constexpr int P1_STAGES = ZT_P1_STAGES;    // ring depth
constexpr int P1_BLOCKS_PER_SM = ZT_P1_BLOCKS_PER_SM;
constexpr int P1_SKIP = ZT_P1_SKIP;
constexpr int P1_CONSUMERS = 256;
constexpr int P1_WARPS = P1_CONSUMERS / 32;
constexpr int P1_THREADS = P1_CONSUMERS + (P1_COPY == 0 ? 32 : 0);  // and the producer warp
[[maybe_unused]] constexpr int P1_UNROLL = 4;  // __ldg build: 16-byte loads of k and of v in flight per thread
constexpr int P1_RING_BYTES = P1_COPY == 2 ? 0 : P1_STAGES * 2 * P1_TILE;
static_assert(P1_TILE % 16 == 0 && P1_STAGES >= 2, "tiles are whole 16-byte vectors; the ring needs two stages");

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the fp32 sum of one 16-byte vector of k and one of v
template <int EPV>
__device__ __forceinline__ float vec_sum(const uint4& kq, const uint4& vq) {
  float kx[EPV], vx[EPV], s = 0.f;
  unpack(kq, kx);
  unpack(vq, vx);
#pragma unroll
  for (int e = 0; e < EPV; ++e) s += kx[e] + vx[e];
  return s;
}

// the consumer warps' own barrier (the producer warp takes no part in it)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(P1_CONSUMERS) : "memory"); }

// k/v (B, Hkv, T, D) contiguous; sums (B / rb,) fp32, zeroed; out (B, H, D). rbb: bytes
// of k (and of v) per row block; tpb: tiles per row block; ntiles = (B / rb) * tpb;
// nout: the 16-byte k/v vectors that make up out, B * H * D / EPV.
template <typename KT, typename OT>
__global__ void __launch_bounds__(P1_THREADS, P1_BLOCKS_PER_SM)
    stream_kernel(const KT* __restrict__ k, const KT* __restrict__ v, float* __restrict__ sums,
                  OT* __restrict__ out, int H, int Hkv, int Tlen, int D, int rb, int chunk,
                  long long rbb, int tpb, long long ntiles, long long nout) {
  constexpr int EPV = 16 / sizeof(KT);  // elements per 16-byte vector
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[P1_STAGES], empty[P1_STAGES];
  __shared__ float warp_part[P1_WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long first = ntiles * blockIdx.x / gridDim.x;
  const int cnt = (int)(ntiles * (blockIdx.x + 1) / gridDim.x - first);  // this block's tiles
  const char* kb = reinterpret_cast<const char*>(k);
  const char* vb = reinterpret_cast<const char*>(v);

  // tile first + it: its row block, its byte offset into k and v, its bytes
  auto tile = [&](int it, int& bb, long long& off, int& bytes) {
    const long long i = first + it;
    bb = (int)(i / tpb);
    const long long in = (i - (long long)bb * tpb) * P1_TILE;
    off = bb * rbb + in;
    bytes = (int)min((long long)P1_TILE, rbb - in);
  };

  if constexpr (P1_COPY == 0) {
    if (tid == 0) {
      for (int s = 0; s < P1_STAGES; ++s) {
        mbar_init(&full[s], 1);          // the producer's arrival, with the bytes it expects
        mbar_init(&empty[s], P1_WARPS);  // one arrival per consumer warp
      }
      mbar_init_fence();
    }
    __syncthreads();
    if (warp == P1_WARPS) {  // the producer warp: one lane starts every copy of the block
      if (lane == 0) {
        for (int it = 0; it < cnt; ++it) {
          const int s = it % P1_STAGES;
          mbar_wait(&empty[s], ((it / P1_STAGES) & 1) ^ 1);
          int bb, bytes;
          long long off;
          tile(it, bb, off, bytes);
          mbar_arrive_expect_tx(&full[s], 2 * bytes);
          bulk_copy_g2s(ring + (size_t)s * 2 * P1_TILE, kb + off, bytes, &full[s]);
          bulk_copy_g2s(ring + (size_t)s * 2 * P1_TILE + P1_TILE, vb + off, bytes, &full[s]);
        }
      }
      return;
    }
  }

  // cp.async build: every consumer thread copies its vectors of tile `it` into stage
  // it % P1_STAGES; one group per call, empty past the last tile
  auto stage_tile = [&](int it) {
    if (it < cnt) {
      int bb, bytes;
      long long off;
      tile(it, bb, off, bytes);
      unsigned char* dst = ring + (size_t)(it % P1_STAGES) * 2 * P1_TILE;
      for (int i = tid * 16; i < bytes; i += P1_CONSUMERS * 16) {
        cp_async16(dst + i, kb + off + i);
        cp_async16(dst + P1_TILE + i, vb + off + i);
      }
    }
    cp_async_commit();
  };
  if constexpr (P1_COPY == 1) {
#pragma unroll
    for (int i = 0; i < P1_STAGES - 1; ++i) stage_tile(i);
  }

  // out: vector i is dims dv * EPV .. of flattened row f of row block bb; row f is
  // slot s of (row r, kv head h) of the row block in every chunk
  if constexpr (!(P1_SKIP & 2)) {
    const int vpr = D / EPV, rows = rb * H, nc = Tlen / chunk;
    for (long long i = (long long)blockIdx.x * P1_CONSUMERS + tid; i < nout; i += (long long)gridDim.x * P1_CONSUMERS) {
      const int dv = (int)(i % vpr);
      const long long fr = i / vpr;
      const int f = (int)(fr % rows), bb = (int)(fr / rows);
      const int s = f % chunk, rh = f / chunk;
      const int h = rh % Hkv, r = rh / Hkv;
      const long long base = ((((long long)bb * rb + r) * Hkv + h) * Tlen + s) * D + dv * EPV;
      float a[EPV] = {};
#pragma unroll 4
      for (int c = 0; c < nc; ++c) {
        const long long e0 = base + (long long)c * chunk * D;
        float kx[EPV], vx[EPV];
        unpack(__ldg(reinterpret_cast<const uint4*>(k + e0)), kx);
        unpack(__ldg(reinterpret_cast<const uint4*>(v + e0)), vx);
#pragma unroll
        for (int e = 0; e < EPV; ++e) a[e] += kx[e] + vx[e];
      }
#pragma unroll
      for (int e = 0; e < EPV; ++e) out[i * EPV + e] = from_f<OT>(a[e]);
    }
  }

  float total = 0.f;
  int cur = -1;  // the row block `total` belongs to
  auto flush = [&]() {
    const float s = warp_sum(total);
    if (lane == 0) warp_part[warp] = s;
    consumer_sync();
    if (tid == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < P1_WARPS; ++w) t += warp_part[w];
      atomicAdd(sums + cur, t);
    }
    consumer_sync();
    total = 0.f;
  };

  for (int it = 0; it < cnt; ++it) {
    int bb, bytes;
    long long off;
    tile(it, bb, off, bytes);
    if (bb != cur) {
      if (cur >= 0) flush();
      cur = bb;
    }
    const int s = it % P1_STAGES;
    if constexpr (P1_COPY == 2) {
      const uint4* kt = reinterpret_cast<const uint4*>(kb + off);
      const uint4* vt = reinterpret_cast<const uint4*>(vb + off);
      const int nvec = bytes / 16;
      for (int i0 = tid; i0 < nvec; i0 += P1_CONSUMERS * P1_UNROLL) {
        uint4 kr[P1_UNROLL], vr[P1_UNROLL];
#pragma unroll
        for (int u = 0; u < P1_UNROLL; ++u) {
          const int i = i0 + u * P1_CONSUMERS;
          if (i < nvec) {
            kr[u] = __ldg(kt + i);
            vr[u] = __ldg(vt + i);
          }
        }
#pragma unroll
        for (int u = 0; u < P1_UNROLL; ++u)
          if (i0 + u * P1_CONSUMERS < nvec) total += vec_sum<EPV>(kr[u], vr[u]);
      }
    } else {
      if constexpr (P1_COPY == 0) {
        mbar_wait(&full[s], (it / P1_STAGES) & 1);
      } else {
        cp_async_wait<P1_STAGES - 2>();
        consumer_sync();  // tile `it` is in; every thread is done with tile it - 1's stage
        stage_tile(it + P1_STAGES - 1);
      }
      if constexpr (!(P1_SKIP & 1)) {
        const uint4* kt = reinterpret_cast<const uint4*>(ring + (size_t)s * 2 * P1_TILE);
        const uint4* vt = reinterpret_cast<const uint4*>(ring + (size_t)s * 2 * P1_TILE + P1_TILE);
        const int nvec = bytes / 16;
#pragma unroll 2
        for (int i = tid; i < nvec; i += P1_CONSUMERS) total += vec_sum<EPV>(kt[i], vt[i]);
      }
      if constexpr (P1_COPY == 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
  }
  if constexpr (P1_COPY == 1) cp_async_wait<0>();
  if (cur >= 0) flush();
}

template <typename KT, typename OT>
static int launch_stream(const void* k, const void* v, float* sums, void* out, int B, int H, int Hkv, int T,
                         int D, int rb, int chunk, cudaStream_t stream) {
  static int sms = 0;           // of the current device, asked once
  static int smem_allowed = 48 << 10;  // raised once per instantiation
  cudaError_t e;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
  }
  if (P1_RING_BYTES > smem_allowed) {
    e = cudaFuncSetAttribute(stream_kernel<KT, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, P1_RING_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = P1_RING_BYTES;
  }
  const int nb = B / rb;
  if (!(P1_SKIP & 4)) {
    if ((e = cudaMemsetAsync(sums, 0, sizeof(float) * nb, stream)) != cudaSuccess) return static_cast<int>(e);
  }
  const long long rbb = (long long)rb * Hkv * T * D * (long long)sizeof(KT);
  const long long tpb = (rbb + P1_TILE - 1) / P1_TILE;
  if (tpb > 0x7fffffffLL) return ZT_UNSUPPORTED;
  const long long nout = (long long)B * H * D * (long long)sizeof(KT) / 16;
  stream_kernel<KT, OT><<<sms * P1_BLOCKS_PER_SM, P1_THREADS, P1_RING_BYTES, stream>>>(
      static_cast<const KT*>(k), static_cast<const KT*>(v), sums, static_cast<OT*>(out), H, Hkv, T, D, rb,
      chunk, rbb, (int)tpb, nb * tpb, nout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace zt

// How this build streams: 0 the copy (0 bulk asynchronous, 1 cp.async, 2 __ldg), 1 the
// tile's bytes of k and of v, 2 the ring's stages, 3 the blocks per SM, 4 the parts
// left out (0 in the build the wrapper uses).
extern "C" int zt_probe_stream_plan(int what) {
  using namespace zt;
  const int plan[5] = {P1_COPY, P1_TILE, P1_STAGES, P1_BLOCKS_PER_SM, P1_SKIP};
  return what >= 0 && what < 5 ? plan[what] : ZT_UNSUPPORTED;
}

// k/v (B, Hkv, T, D) contiguous and 16-byte aligned, of the dtype kv_dtype, rows whole
// 16-byte vectors; sums (B / rb,) fp32 (cleared here); out (B, H, D) contiguous in
// out_dtype. One memset and one launch.
extern "C" int zt_probe_stream(const void* k, const void* v, float* sums, void* out, int B, int H, int Hkv,
                               int T, int D, int rb, int chunk, int kv_dtype, int out_dtype, void* stream) {
  using namespace zt;
  cudaGetLastError();
  const int esize = kv_dtype == F32 ? 4 : 2;
  if (B <= 0 || rb <= 0 || B % rb != 0 || chunk <= 0 || T % chunk != 0 || Hkv <= 0 || H * rb > 64 ||
      H > (long long)Hkv * chunk || (D * esize) % 16 != 0)
    return ZT_UNSUPPORTED;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_STREAM(KK, OO) return launch_stream<KK, OO>(k, v, sums, out, B, H, Hkv, T, D, rb, chunk, st)
  if (kv_dtype == F32 && out_dtype == F32) { ZT_STREAM(float, float); }
  if (kv_dtype == F32 && out_dtype == BF16) { ZT_STREAM(float, __nv_bfloat16); }
  if (kv_dtype == BF16 && out_dtype == F32) { ZT_STREAM(__nv_bfloat16, float); }
  if (kv_dtype == BF16 && out_dtype == BF16) { ZT_STREAM(__nv_bfloat16, __nv_bfloat16); }
#undef ZT_STREAM
  return ZT_UNSUPPORTED;
}
