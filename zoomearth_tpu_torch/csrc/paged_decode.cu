// K4: single-token GQA decode attention over a paged KV pool, hand-written for Hopper.
//
// Replaces zoomearth_tpu/ops/paged_attention.py::paged_decode_attention (Pallas,
// pallas_call at :130, body _kernel at :37).
//
// Semantics: q (B, H, D) for one new token per row attends to the first lengths[b]
// slots of its sequence. Slot t of row b lives at pool[bt[b, t / page], h, t % page, :]
// for k and v alike; bt is the (B, max_pages) block table. Entries at or past row b's
// page count ceil(lengths[b] / page) are arbitrary and are never read. A row with no
// live slot returns 0, as the Pallas kernel does (acc / max(l, 1e-30) with l = 0).
//
// What bounds it on the card: bytes, like K3. Each pool byte is used by the G = 8
// query heads of its kv head for one multiply-add each.
//
// What the design does about it: it walks exactly the row's pages, page by page, and
// in each page reads only the live slots t < lengths[b]. The block reads its own row
// of the block table (the counterpart of the TPU's scalar prefetch): one id per page,
// a broadcast load, then a 64-bit offset into the pool. Inside a page the work is
// K3's (common.cuh decode_step): 8 warps take slots in turn, each k/v row is read
// once, coalesced across a warp's lanes, and serves all G query heads. One block per
// (row, kv head): the reference's shapes (B = 32 and 64, Hkv = 2) launch 64 and 128
// blocks on 132 SMs, against K3's 16 in the smoke. No split along the pages yet.
#include "common.cuh"

namespace zt {

template <int DPL, typename T>
__global__ void __launch_bounds__(DEC_WARPS * 32)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool, const int* __restrict__ block_table,
                        const int* __restrict__ npages, const int* __restrict__ lengths,
                        T* __restrict__ out, int Hkv, int page, int D, int G, long long bt_sb,
                        long long p_sp, long long p_sh, long long p_st, float scale) {
  __shared__ DecodeSmem<DPL> sm;

  const int b = blockIdx.x / Hkv;
  const int kh = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lengths[b];
  const int n = npages[b];
  const int* bt = block_table + (long long)b * bt_sb;

  DecodeState<DPL> st;
  decode_init(st, q + ((long long)b * Hkv * G + kh * G) * D, (long long)D, D, G, scale, lane);
  for (int i = 0; i < n; ++i) {
    const long long base = (long long)__ldg(bt + i) * p_sp + (long long)kh * p_sh;
    const int live = min(page, len - i * page);  // slots of this page below lengths[b]
    for (int s = warp; s < live; s += DEC_WARPS) {
      const long long o = base + (long long)s * p_st;
      decode_step(st, kpool + o, vpool + o, 1.f, 1.f, D, G, lane);
    }
  }
  decode_finish(st, sm, out + ((long long)b * Hkv * G + kh * G) * D, D, G, warp, lane);
}

}  // namespace zt

// q (B, H, D) contiguous; kpool/vpool (P, Hkv, page, D) with one set of strides and
// unit stride on D; block_table (B, max_pages) int32 with unit stride on pages;
// npages and lengths (B,) int32, lengths clipped to [0, max_pages * page] and
// npages = ceil(lengths / page); out a contiguous (B, H, D) tensor.
extern "C" int zt_paged_decode(const void* q, const void* kpool, const void* vpool,
                               const int* block_table, const int* npages, const int* lengths,
                               void* out, int B, int H, int Hkv, int page, int D,
                               long long bt_sb, long long p_sp, long long p_sh, long long p_st,
                               float scale, int dtype, void* stream) {
  using namespace zt;
  cudaGetLastError();
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0) return ZT_UNSUPPORTED;
  const int G = H / Hkv;
  if (G > DEC_MAXG || D <= 0 || D > 128) return ZT_UNSUPPORTED;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_PAGED(TT)                                                                         \
  paged_decode_kernel<4, TT><<<B * Hkv, DEC_WARPS * 32, 0, st>>>(                            \
      static_cast<const TT*>(q), static_cast<const TT*>(kpool), static_cast<const TT*>(vpool), \
      block_table, npages, lengths, static_cast<TT*>(out), Hkv, page, D, G, bt_sb, p_sp, p_sh, \
      p_st, scale);                                                                          \
  return static_cast<int>(cudaGetLastError());
  if (dtype == F32) { ZT_PAGED(float) }
  if (dtype == BF16) { ZT_PAGED(__nv_bfloat16) }
#undef ZT_PAGED
  return ZT_UNSUPPORTED;
}
