// K3: single-token GQA decode attention over the slot cache, hand-written for Hopper.
//
// Replaces zoomearth_tpu/ops/flash_decode.py::flash_decode_attention (Pallas,
// pallas_call at :157, body _kernel at :37).
//
// Semantics: q (B, H, D) for one new token per row attends to the first kv_len[b]
// slots of the (B, Hkv, T, D) cache. Any T is accepted (the TPU kernel's T % 512
// rule does not carry over), and the cache may be a strided prefix view (the
// decoder's attend_len slice) — it is read through its strides, never copied.
// With int8 K/V the per-token scales apply to logit columns and to p before p@v.
//
// What bounds it on the card: bytes. Each cache byte is used by G = 8 query heads
// for one multiply-add each, far below the H100's ~295 flops/byte balance point.
//
// What the design does about it: it reads only the live slots t < kv_len[b] (cache
// reads scale with the live length, not with T), each k/v row once, coalesced
// across a warp's lanes, and shares it across the G query heads of its kv head.
// One block per (row, kv head); its 8 warps take interleaved slots and each keeps
// an fp32 online softmax per head, merged through shared memory at the end. The
// simple first version has no split across blocks along T, so a small batch fills
// only B x Hkv SMs; split-K comes later.
#include "common.cuh"

namespace zt {

template <int DPL, typename QT, typename KT>
__global__ void __launch_bounds__(DEC_WARPS * 32)
    flash_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v, const float* __restrict__ ksc,
                        const float* __restrict__ vsc, const int* __restrict__ kv_len,
                        QT* __restrict__ out, int Hkv, int T, int D, int G, long long q_sb,
                        long long q_sh, long long k_sb, long long k_sh, long long k_st,
                        long long v_sb, long long v_sh, long long v_st, long long sc_sb,
                        long long sc_sh, float scale) {
  constexpr bool QUANT = sizeof(KT) == 1;
  __shared__ DecodeSmem<DPL> sm;

  const int b = blockIdx.x / Hkv;
  const int kh = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int klen = min(max(kv_len[b], 0), T);

  DecodeState<DPL> st;
  decode_init(st, q + (long long)b * q_sb + (long long)(kh * G) * q_sh, q_sh, D, G, scale, lane);
  const KT* kb = k + (long long)b * k_sb + (long long)kh * k_sh;
  const KT* vb = v + (long long)b * v_sb + (long long)kh * v_sh;
  for (int t = warp; t < klen; t += DEC_WARPS) {
    float kscale = 1.f, vscale = 1.f;
    if (QUANT) {
      const long long o = (long long)b * sc_sb + (long long)kh * sc_sh + t;
      kscale = ksc[o];
      vscale = vsc[o];
    }
    decode_step(st, kb + (long long)t * k_st, vb + (long long)t * v_st, kscale, vscale, D, G, lane);
  }
  decode_finish(st, sm, out + ((long long)b * Hkv * G + kh * G) * D, D, G, warp, lane);
}

template <int DPL, typename QT, typename KT>
static int launch_decode(const void* q, const void* k, const void* v, const float* ksc,
                         const float* vsc, const int* kv_len, void* out, int B, int Hkv, int T,
                         int D, int G, long long q_sb, long long q_sh, long long k_sb,
                         long long k_sh, long long k_st, long long v_sb, long long v_sh,
                         long long v_st, long long sc_sb, long long sc_sh, float scale,
                         cudaStream_t stream) {
  flash_decode_kernel<DPL, QT, KT><<<B * Hkv, DEC_WARPS * 32, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), ksc, vsc,
      kv_len, static_cast<QT*>(out), Hkv, T, D, G, q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
      sc_sb, sc_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace zt

// q (B, H, D) with unit stride on D; k/v (B, Hkv, T, D) with unit stride on D (T may
// be a prefix view of a longer cache); kv_len (B,) int32; ksc/vsc (B, Hkv, T) fp32 with
// unit stride on T (int8 K/V only, else null); out a contiguous (B, H, D) tensor.
extern "C" int zt_flash_decode(const void* q, const void* k, const void* v, const float* ksc,
                               const float* vsc, const int* kv_len, void* out, int B, int H,
                               int Hkv, int T, int D, long long q_sb, long long q_sh,
                               long long k_sb, long long k_sh, long long k_st, long long v_sb,
                               long long v_sh, long long v_st, long long sc_sb, long long sc_sh,
                               float scale, int q_dtype, int kv_dtype, void* stream) {
  using namespace zt;
  cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0) return ZT_UNSUPPORTED;
  const int G = H / Hkv;
  if (G > DEC_MAXG || D <= 0 || D > 128) return ZT_UNSUPPORTED;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_DEC(PP, QQ, KK)                                                                     \
  return launch_decode<PP, QQ, KK>(q, k, v, ksc, vsc, kv_len, out, B, Hkv, T, D, G, q_sb, q_sh, \
                                   k_sb, k_sh, k_st, v_sb, v_sh, v_st, sc_sb, sc_sh, scale, st)
#define ZT_DEC_D(QQ, KK)                   \
  if (D <= 32) { ZT_DEC(1, QQ, KK); }      \
  if (D <= 64) { ZT_DEC(2, QQ, KK); }      \
  ZT_DEC(4, QQ, KK);
  if (q_dtype == F32 && kv_dtype == F32) { ZT_DEC_D(float, float) }
  if (q_dtype == BF16 && kv_dtype == BF16) { ZT_DEC_D(__nv_bfloat16, __nv_bfloat16) }
  if (q_dtype == F32 && kv_dtype == I8) { ZT_DEC_D(float, int8_t) }
  if (q_dtype == BF16 && kv_dtype == I8) { ZT_DEC_D(__nv_bfloat16, int8_t) }
#undef ZT_DEC_D
#undef ZT_DEC
  return ZT_UNSUPPORTED;
}
