// Shared helpers for the hand-written Hopper attention kernels (sm_90a).
//
// The kernels are plain CUDA C++ with a C interface (loaded by ctypes from
// zoomearth_tpu_torch/ops/_cuda.py). Every entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() after the launch
// (or ZT_UNSUPPORTED for a shape/dtype it has no instantiation for).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace zt {

constexpr float NEG_INF = -1e30f;  // the reference's masking value (never -inf)
constexpr int ZT_UNSUPPORTED = -1;

// dtype codes shared with the Python wrappers (ops/_cuda.py DTYPE_CODES)
enum DType { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ bool is_live(float logit) { return logit > 0.5f * NEG_INF; }

// One online-softmax step over a shared-memory tile of BKV kv rows for one query
// row whose D dims are spread over TPR threads (thread j owns dims i*TPR + j).
// sc holds the row's masked logits (NEG_INF = masked); vtile is the (BKV, D) fp32
// value tile; vscale (nullable) multiplies p before p@v (int8 per-token scales).
template <int DPT, int TPR, int BKV>
__device__ __forceinline__ void softmax_tile(const float (&sc)[BKV], const float* vtile, int D,
                                             const float* vscale, int j, float& m, float& l,
                                             float (&acc)[DPT]) {
  float m_tile = NEG_INF;
#pragma unroll
  for (int t = 0; t < BKV; ++t) m_tile = fmaxf(m_tile, sc[t]);
  const float m_new = fmaxf(m, m_tile);
  const float alpha = expf(m - m_new);
  l *= alpha;
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
  for (int t = 0; t < BKV; ++t) {
    const float p = is_live(sc[t]) ? expf(sc[t] - m_new) : 0.f;
    l += p;
    const float pv = vscale != nullptr ? p * vscale[t] : p;
    const float* vr = vtile + t * D + j;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = fmaf(pv, vr[i * TPR], acc[i]);
  }
  m = m_new;
}

// Sum over the TPR (= 4) consecutive lanes that share one query row.
__device__ __forceinline__ float group4_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// ---------------------------------------------------------------------------
// Asynchronous 16-byte copies from device memory to shared memory (cp.async .cg:
// cached in L2 only). A thread's copies are visible to the block after
// cp_async_wait and a barrier.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 4-byte copy (.ca: the only kind that takes 4 bytes), for values off a 16-byte grid
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// The same copies with a source size: `ok` copies the bytes, else the destination is
// filled with zeros and nothing is read (src must still be a valid address). L1
// chooses .ca (cached in L1 too) over .cg for the 16-byte one.
template <bool L1>
__device__ __forceinline__ void cp_async16_z(void* dst, const void* src, bool ok) {
  if constexpr (L1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(ok ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async4_z(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Bulk asynchronous copies (the TMA's 1-D copy: no tensor map) and the shared-memory
// barriers (mbarrier) that count their bytes in. One thread starts a copy of any
// multiple of 16 bytes between 16-byte aligned addresses; the barrier's phase
// completes when its expected arrivals have arrived and its expected bytes have
// landed, and a thread that sees the phase complete sees the bytes. A wait names the
// parity of the phase it waits for: phases alternate 0, 1, 0, ... from init, and a
// wait on the parity of the phase before the current one passes at once.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(void* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals) : "memory");
}

// after the inits, by the thread that made them, before a barrier of the block: makes
// them visible to the other threads and to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also tells the barrier how many copied bytes this phase expects
__device__ __forceinline__ void mbar_arrive_expect_tx(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from device memory to shared memory, counted in on `bar`
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, unsigned bytes, void* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Tensor-core fragments (mma.sync m16n8k16, bf16 in, fp32 accumulate), shared by
// K1/K2's flash core (flash_mma.cuh) and P2. With g = lane / 4, t = lane % 4, the
// fp32 C fragment holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at columns
// 2t, 2t + 1; rounded to bf16 and packed in pairs, the C fragments of two
// neighbouring n8 tiles are exactly the A fragment of a product over those 16
// columns, so softmax weights never leave registers.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d = a (16x16 bf16, row) * b (16x8 bf16, col) + c, fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1, const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// ---------------------------------------------------------------------------
// The split merge shared by K3, K4, K5 and P2. All four split the key axis of each (row, kv
// head) pair across blocks; each block leaves, per query head g of the pair, its
// softmax state over its keys: m (max logit), l (sum of e^(logit - m)) and acc[D]
// (sum of e^(logit - m) v), all fp32, in one scratch buffer laid out as
// acc [pair][split][G][D] (first, so that its rows stay 16-byte aligned),
// m [pair][split][G], l [pair][split][G].
// The merge writes out[pair][g][d] = sum_s e^(m_s - M) acc_s[d] / max(sum_s
// e^(m_s - M) l_s, 1e-30), M = max_s m_s, over the splits the pair walked: the
// first ceil(walked / split_len), with walked = len[pair / len_div] * len_mul, or
// dead_len where that is 0 (dead_len 0: such a pair walked nothing and gets 0).
// G <= SPLIT_MAXG, D a multiple of 4 up to SPLIT_MAXD (K5's 16 heads of 512 dims).
// Implemented in split_merge.cu.
// ---------------------------------------------------------------------------
constexpr int SPLIT_MAXG = 16;
constexpr int SPLIT_MAXD = 512;

struct SplitPartials {
  float* m;
  float* l;
  float* acc;
};

__host__ __device__ __forceinline__ SplitPartials split_partials(float* base, int pairs, int nsplit, int G, int D) {
  const long long n = (long long)pairs * nsplit * G;
  return {base + n * D, base + n * D + n, base};
}

int launch_split_merge(const float* part, const int* len, int len_div, int len_mul, int dead_len,
                       int split_len, int nsplit, void* out, int out_dtype, int pairs, int G, int D,
                       cudaStream_t stream);

}  // namespace zt
