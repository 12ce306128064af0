// P1: the decode KV stream probe, hand-written for Hopper.
//
// Replaces scripts/probe_attn.py::stream_only (Pallas, pallas_call at :49, body
// _stream_kernel at :25): it reads the same k/v blocks as decode attention with a
// trivial reduction, so its time is the floor that K3 (and P2) are held against.
//
// Semantics (the TPU probe's output): row blocks of rb rows; per row block bb and
// chunk c, the (rb, Hkv, chunk, D) k and v blocks are flattened to rows ordered
// (row, kv head, slot) and their first 64 rows summed (k + v) in fp32 over the
// chunks; out (B, Hkv, G, D) holds the first rb * Hkv * G of those 64 rows. Needs
// B % rb == 0, T % chunk == 0 and rb * Hkv * G <= 64. Beside it, sums (B / rb,) holds
// the fp32 sum of every k and v element the row block read: a load whose value went
// nowhere would be deleted by the compiler, and the probe would time no reads.
//
// What bounds it on the card: bytes (one add per element read).
//
// What the design does about it: a block owns a tile of 64 slots of one (row, kv
// head) and reads its k and v rows as 16-byte vectors, consecutive threads on
// consecutive addresses, several loads in flight per thread. B * Hkv * T / 64 blocks
// (1536 at the probe's B = 32, T = 1536) keep every SM streaming. Each block adds its
// sum into sums[bb] with one atomic; the few slots that fall in the first 64 rows
// of a chunk's flattened block add into an fp32 accumulator, which a second small
// kernel casts to out.
#include "common.cuh"

namespace zt {

constexpr int STREAM_TILE = 64;      // slots per block
constexpr int STREAM_THREADS = 256;
constexpr int STREAM_UNROLL = 4;     // 16-byte loads of k and of v in flight per thread

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

// k/v (B, Hkv, T, D) contiguous; acc (B / rb, 64, D) and sums (B / rb,) fp32, zeroed.
template <typename T>
__global__ void __launch_bounds__(STREAM_THREADS)
    stream_kernel(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ acc,
                  float* __restrict__ sums, int Hkv, int Tlen, int D, int rb, int chunk) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  __shared__ float warp_sums[STREAM_THREADS / 32];
  const int tiles = (Tlen + STREAM_TILE - 1) / STREAM_TILE;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % Hkv;
  const int b = blockIdx.x / (tiles * Hkv);
  const int bb = b / rb;
  const int vpr = D / EPV;  // vectors per row
  const int t0 = tile * STREAM_TILE;
  const int rows = min(STREAM_TILE, Tlen - t0);
  const long long base = (((long long)b * Hkv + h) * Tlen + t0) * D;
  const uint4* kt = reinterpret_cast<const uint4*>(k + base);
  const uint4* vt = reinterpret_cast<const uint4*>(v + base);
  const int nvec = rows * vpr;
  // rows (row, kv head) of a chunk's flattened block that precede this (b, h)
  const int flat0 = chunk * (h + Hkv * (b % rb));

  float total = 0.f;
  for (int i0 = threadIdx.x; i0 < nvec; i0 += STREAM_THREADS * STREAM_UNROLL) {
    uint4 kr[STREAM_UNROLL], vr[STREAM_UNROLL];
#pragma unroll
    for (int u = 0; u < STREAM_UNROLL; ++u) {
      const int i = i0 + u * STREAM_THREADS;
      if (i < nvec) {
        kr[u] = __ldg(kt + i);
        vr[u] = __ldg(vt + i);
      }
    }
#pragma unroll
    for (int u = 0; u < STREAM_UNROLL; ++u) {
      const int i = i0 + u * STREAM_THREADS;
      if (i < nvec) {
        float kx[EPV], vx[EPV];
        unpack(kr[u], kx);
        unpack(vr[u], vx);
        const int t = t0 + i / vpr;
        const int f = flat0 + t % chunk;  // row in the chunk's flattened block
#pragma unroll
        for (int e = 0; e < EPV; ++e) total += kx[e] + vx[e];
        if (f < 64) {
          float* a = acc + ((long long)bb * 64 + f) * D + (i % vpr) * EPV;
#pragma unroll
          for (int e = 0; e < EPV; ++e) atomicAdd(a + e, kx[e] + vx[e]);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < STREAM_THREADS / 32; ++w) s += warp_sums[w];
    atomicAdd(sums + bb, s);
  }
}

// out (B / rb, rows, D) in the query dtype from acc (B / rb, 64, D), rows <= 64.
template <typename T>
__global__ void stream_finish_kernel(const float* __restrict__ acc, T* __restrict__ out, int rows,
                                     int D, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long bb = i / ((long long)rows * D);
    const long long r = i - bb * rows * D;
    out[i] = from_f<T>(acc[bb * 64 * D + r]);
  }
}

}  // namespace zt

// k/v (B, Hkv, T, D) contiguous and 16-byte aligned, of the dtype kv_dtype; acc
// (B / rb, 64, D) and sums (B / rb,) fp32, zeroed; out (B, H, D) contiguous in
// out_dtype. B % rb == 0, T % chunk == 0 and H * rb <= 64 are the caller's to check.
extern "C" int zt_probe_stream(const void* k, const void* v, float* acc, float* sums, void* out,
                               int B, int H, int Hkv, int T, int D, int rb, int chunk,
                               int kv_dtype, int out_dtype, void* stream) {
  using namespace zt;
  cudaGetLastError();
  const int esize = kv_dtype == F32 ? 4 : 2;
  if (B <= 0 || rb <= 0 || B % rb != 0 || chunk <= 0 || T % chunk != 0 || H * rb > 64 ||
      (D * esize) % 16 != 0 || Hkv <= 0)
    return ZT_UNSUPPORTED;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * Hkv * ((T + STREAM_TILE - 1) / STREAM_TILE);
  if (kv_dtype == F32) {
    stream_kernel<float><<<blocks, STREAM_THREADS, 0, st>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), acc, sums, Hkv, T, D, rb, chunk);
  } else if (kv_dtype == BF16) {
    stream_kernel<__nv_bfloat16><<<blocks, STREAM_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), acc, sums, Hkv,
        T, D, rb, chunk);
  } else {
    return ZT_UNSUPPORTED;
  }
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int rows = rb * H;
  const long long n = (long long)(B / rb) * rows * D;
  const int fblocks = (int)((n + 255) / 256);
  if (out_dtype == F32) {
    stream_finish_kernel<float><<<fblocks, 256, 0, st>>>(acc, static_cast<float*>(out), rows, D, n);
  } else if (out_dtype == BF16) {
    stream_finish_kernel<__nv_bfloat16><<<fblocks, 256, 0, st>>>(
        acc, static_cast<__nv_bfloat16*>(out), rows, D, n);
  } else {
    return ZT_UNSUPPORTED;
  }
  return static_cast<int>(cudaGetLastError());
}
