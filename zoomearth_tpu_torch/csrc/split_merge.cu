// The split merge shared by K3 (flash_decode.cu), K4 (paged_decode.cu) and P2
// (probe_bigmm.cu).
//
// These kernels split the key axis of every (row, kv head) pair across blocks, so
// that a small batch still fills the card; each block leaves a partial softmax state
// per query head (see SplitPartials in common.cuh). This second pass combines them:
// the online-softmax merge of two states, taken over the blocks of one pair. It
// reads only the splits the pair walked, a count it computes on the device from the
// row lengths (K3: kv_len, K4: lengths) or the chunk counts (P2: ncb), so the host
// never waits for those values. Splits with equal m weigh alike, which is what gives
// a row with every logit masked (or, in K3, every logit equal) the mean of v. A pair
// that walked no split (K4's row with no live slot, dead_len 0) gets 0.
//
// What bounds it: latency. It reads pairs x walked splits x G x (D + 2) fp32 values
// that the first pass has just written (L2-resident). So every load of a block is
// issued at once: one block per (pair, query head), each warp takes every
// MERGE_GROUPS-th split; each warp finds the head's max and sum over all splits by
// itself (lanes across splits, one online-softmax pass), then lane j sums dims
// 4j .. 4j + 3 over its warp's splits, and the warps' sums meet in shared memory.
#include "common.cuh"

namespace zt {

constexpr int MERGE_GROUPS = 8;  // warps per block, each over every 8th split
constexpr int MERGE_THREADS = 32 * MERGE_GROUPS;

template <typename OT>
__global__ void __launch_bounds__(MERGE_THREADS)
    split_merge_kernel(const float* __restrict__ part, const int* __restrict__ len, int len_div,
                       int len_mul, int dead_len, int split_len, int nsplit, OT* __restrict__ out, int G,
                       int D) {
  __shared__ float4 red[MERGE_GROUPS][32];
  const int pair = blockIdx.x, g = blockIdx.y;
  const SplitPartials p = split_partials(const_cast<float*>(part), gridDim.x, nsplit, G, D);
  int walked = len[pair / len_div] * len_mul;
  if (walked <= 0) walked = dead_len;
  const int nw = min((walked + split_len - 1) / split_len, nsplit);
  const long long row = (long long)pair * nsplit;  // head g of split s: (row + s) * G + g
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the head's max M and sum L over the walked splits
  float M = NEG_INF, L = 0.f;
  for (int s = lane; s < nw; s += 32) {
    const long long i = (row + s) * G + g;
    const float m = p.m[i], l = p.l[i];
    const float m_new = fmaxf(M, m);
    L = L * expf(M - m_new) + l * expf(m - m_new);
    M = m_new;
  }
  const float Mall = warp_max(M);
  L = fmaxf(warp_sum(L * expf(M - Mall)), 1e-30f);

  // this warp's splits, dims 4 lane .. 4 lane + 3
  const int d = 4 * lane;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  if (d < D) {
#pragma unroll 4
    for (int s = warp; s < nw; s += MERGE_GROUPS) {
      const long long i = (row + s) * G + g;
      const float f = expf(p.m[i] - Mall);
      const float4 a = *reinterpret_cast<const float4*>(p.acc + i * D + d);
      A.x = fmaf(a.x, f, A.x);
      A.y = fmaf(a.y, f, A.y);
      A.z = fmaf(a.z, f, A.z);
      A.w = fmaf(a.w, f, A.w);
    }
  }
  red[warp][lane] = A;
  __syncthreads();
  if (warp == 0 && d < D) {
    for (int w = 1; w < MERGE_GROUPS; ++w) {
      const float4 a = red[w][lane];
      A.x += a.x, A.y += a.y, A.z += a.z, A.w += a.w;
    }
    OT* o = out + ((long long)pair * G + g) * D + d;
    o[0] = from_f<OT>(A.x / L);
    o[1] = from_f<OT>(A.y / L);
    o[2] = from_f<OT>(A.z / L);
    o[3] = from_f<OT>(A.w / L);
  }
}

int launch_split_merge(const float* part, const int* len, int len_div, int len_mul, int dead_len,
                       int split_len, int nsplit, void* out, int out_dtype, int pairs, int G, int D,
                       cudaStream_t stream) {
  if (G > SPLIT_MAXG || D % 4 != 0 || D > 4 * 32) return ZT_UNSUPPORTED;
  const dim3 grid(pairs, G);
  if (out_dtype == F32) {
    split_merge_kernel<float><<<grid, MERGE_THREADS, 0, stream>>>(part, len, len_div, len_mul, dead_len,
                                                                  split_len, nsplit, static_cast<float*>(out), G, D);
  } else if (out_dtype == BF16) {
    split_merge_kernel<__nv_bfloat16><<<grid, MERGE_THREADS, 0, stream>>>(
        part, len, len_div, len_mul, dead_len, split_len, nsplit, static_cast<__nv_bfloat16*>(out), G, D);
  } else {
    return ZT_UNSUPPORTED;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace zt
