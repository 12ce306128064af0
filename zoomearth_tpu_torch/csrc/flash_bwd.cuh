// What the backward kernels of K1 (flash_segment_bwd.cu) and K2 (flash_causal_bwd.cu)
// share: their thread layout and the per-pair arithmetic (flash_segment_bwd.cu's
// zt_flash_bwd_rows tells the wrappers how many rows a block owns).
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
// nothing to dk or dv, whatever its lse holds.
//
// Design (the first, simple version: right and deterministic; tensor cores are later
// work): fp32 FMA arithmetic on fp32 copies of the tiles in shared memory, for fp32
// and bf16 inputs alike. Two kernels per call, no atomics:
// - dq: a block owns ROWS query rows and walks their key range in tiles of BWD_TILE
//   keys; its prologue computes delta for its rows and writes it out;
// - dk/dv: launched after dq on the same stream, a block owns ROWS keys, holds their
//   k and v rows and dk/dv accumulators in registers, and walks the query rows that
//   see them in tiles of BWD_TILE rows (reading delta).
// A row's D values are spread over TPR threads (thread j owns dims i * TPR + j), as in
// the forward's fp32 variant; dot products end in a TPR-lane shuffle sum.
//
// What bounds them on the card: operations, and here the fp32 FMA rate (67 TFLOP/s),
// not the tensor cores' 989: each live pair costs 7 D fused multiply-adds (14 D flops)
// over the two kernels (q.k twice, dO.v twice, and the dq, dk and dv updates) against
// the 10 D flops of the five products counted in the bound.
#pragma once

#include "common.cuh"

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

}  // namespace zt
