// K3: single-token GQA decode attention over the slot cache, hand-written for Hopper.
//
// Replaces zoomearth_tpu/ops/flash_decode.py::flash_decode_attention (Pallas,
// pallas_call at :157, body _kernel at :37).
//
// Semantics: q (B, H, D) for one new token per row attends to the first kv_len[b]
// slots of the (B, Hkv, T, D) cache. Any T is accepted (the TPU kernel's T % 512
// rule does not carry over), and the cache may be a strided prefix view (the
// decoder's attend_len slice), read through its strides, never copied. With int8
// K/V the per-token scales apply to logit columns and to p before p@v. A row with
// kv_len == 0 gives what the decoder's XLA decode gives (every logit masked alike):
// the mean of v over all T slots. The kernel reads such a row as T slots with equal
// logits.
//
// What bounds it on the card (bytes, and how many of them are in flight) and what
// the design does about it (the key axis split across blocks, a cp.async ring, fp32
// FMA in three phases per tile, one shared split merge): decode_split.cuh, the split
// pass K3 shares with K4. K3 instantiates it with the slot cache's address policy:
// slot t of row b, kv head h lives at base + b * sb + h * sh + t * st, read through
// the view's own strides. A row with no live slot reads all T slots
// (DEAD_READS_ALL), and the split merge (split_merge.cu) is told so.
#include "decode_split.cuh"

namespace zt {

struct SlotCacheKV {
  static constexpr bool DEAD_READS_ALL = true;
  const char *k, *v;
  long long k_sb, k_sh, k_st, v_sb, v_sh, v_st;  // row, kv head and slot strides in bytes

  struct Rows {
    const char *kbase, *vbase;
    long long k_row, v_row;
    __device__ __forceinline__ const char* k(int t) const { return kbase + t * k_row; }
    __device__ __forceinline__ const char* v(int t) const { return vbase + t * v_row; }
  };

  __device__ __forceinline__ Rows rows(int b, int kh) const {
    return {k + b * k_sb + kh * k_sh, v + b * v_sb + kh * v_sh, k_st, v_st};
  }
};

}  // namespace zt

// Slots per staged tile of the split pass K3 and K4 share: a split is a whole number
// of them (ops/flash_decode.py TILE).
extern "C" int zt_decode_split_tile() { return zt::K3_TILE; }

// q (B, H, D) with unit stride on D; k/v (B, Hkv, T, D) with unit stride on D, rows
// and strides whole 16-byte multiples, base 16-byte aligned (T may be a prefix view
// of a longer cache); kv_len (B,) int32 clipped to [0, T]; ksc/vsc (B, Hkv, T) fp32
// with unit stride on T (int8 K/V only, else null); part the fp32 split scratch of
// B * Hkv * nsplit * G * (D + 2) values, 16-byte aligned; out a contiguous (B, H, D)
// tensor. Launches the split pass over (B * Hkv) x nsplit blocks of split_len slots
// (a multiple of K3_TILE), then the split merge.
extern "C" int zt_flash_decode(const void* q, const void* k, const void* v, const float* ksc,
                               const float* vsc, const int* kv_len, void* part, void* out, int B,
                               int H, int Hkv, int T, int D, int split_len, int nsplit,
                               long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                               long long k_st, long long v_sb, long long v_sh, long long v_st,
                               long long sc_sb, long long sc_sh, float scale, int q_dtype,
                               int kv_dtype, void* stream) {
  using namespace zt;
  cudaGetLastError();
  const int item = kv_dtype == I8 ? 1 : kv_dtype == BF16 ? 2 : 4;
  if (!decode_split_supported(H, Hkv, T, D, item, split_len, nsplit)) return ZT_UNSUPPORTED;
  const int G = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  const SlotCacheKV cache = {static_cast<const char*>(k), static_cast<const char*>(v), k_sb * item, k_sh * item,
                             k_st * item, v_sb * item, v_sh * item, v_st * item};
#define ZT_DEC(QQ, KK)                                                                            \
  return launch_decode_split<QQ, KK>(cache, q, ksc, vsc, kv_len, pt, out, B, Hkv, T, D, G,       \
                                     split_len, nsplit, q_sb, q_sh, sc_sb, sc_sh, scale, q_dtype, st)
  if (q_dtype == F32 && kv_dtype == F32) { ZT_DEC(float, float); }
  if (q_dtype == BF16 && kv_dtype == BF16) { ZT_DEC(__nv_bfloat16, __nv_bfloat16); }
  if (q_dtype == F32 && kv_dtype == I8) { ZT_DEC(float, int8_t); }
  if (q_dtype == BF16 && kv_dtype == I8) { ZT_DEC(__nv_bfloat16, int8_t); }
#undef ZT_DEC
  return ZT_UNSUPPORTED;
}
