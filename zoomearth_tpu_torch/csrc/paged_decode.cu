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
// What bounds it on the card: bytes, and how many of them are in flight, exactly as
// K3: it is K3's function with another answer to "where does slot t live". One block
// per (row, kv head) walking its pages slot by slot, as the first version did, put 64
// or 128 blocks on 132 SMs with one row load in flight per warp and ran ten times
// slower than K3 on the same k/v (NVIDIA H100 80GB HBM3, 700 W).
//
// What the design does about it: K4 is the split pass of decode_split.cuh (the key
// axis split across (B * Hkv) x nsplit blocks from the shapes alone, a cp.async ring
// of 32-slot tiles, fp32 FMA in three phases, then the shared split merge of
// split_merge.cu) instantiated with a paged address policy:
// - Each copied row looks its page up by itself: id = bt[b, t / page], then a 64-bit
//   offset id * page stride + (t % page) * slot stride into the pool. A tile of 32
//   slots may therefore cross pages (pages of 16 hold half a tile), and a split need
//   not start on a page boundary. The table reads are broadcast loads that stay in L1.
// - The pass asks for rows t < lengths[b] only, so a table entry past the row's pages
//   is never read: the copy loop stops at the split's last live slot.
// - A row with no live slot reads nothing (DEAD_READS_ALL = false): its blocks exit
//   at once and the merge, told that such a row walked 0 splits, writes 0.
#include "decode_split.cuh"

namespace zt {

struct PagedKV {
  static constexpr bool DEAD_READS_ALL = false;
  const char *kpool, *vpool;
  const int* block_table;
  long long bt_sb;              // block-table row stride in entries
  long long p_sp, p_sh, p_st;   // page, kv head and slot strides of both pools in bytes
  int page;

  struct Rows {
    const char *kbase, *vbase;
    const int* bt;
    long long p_sp, p_st;
    int page;
    __device__ __forceinline__ long long offset(int t) const {
      const int pg = t / page;
      return (long long)__ldg(bt + pg) * p_sp + (long long)(t - pg * page) * p_st;
    }
    __device__ __forceinline__ const char* k(int t) const { return kbase + offset(t); }
    __device__ __forceinline__ const char* v(int t) const { return vbase + offset(t); }
  };

  __device__ __forceinline__ Rows rows(int b, int kh) const {
    return {kpool + kh * p_sh, vpool + kh * p_sh, block_table + b * bt_sb, p_sp, p_st, page};
  }
};

}  // namespace zt

// q (B, H, D) contiguous; kpool/vpool (P, Hkv, page, D) with one set of strides, unit
// stride on D, rows and strides whole 16-byte multiples from 16-byte aligned bases;
// block_table (B, max_pages) int32 with unit stride on pages; lengths (B,) int32
// clipped to [0, max_pages * page]; part the fp32 split scratch of B * Hkv * nsplit *
// G * (D + 2) values, 16-byte aligned; out a contiguous (B, H, D) tensor. Launches the
// split pass over (B * Hkv) x nsplit blocks of split_len slots (a multiple of
// K3_TILE; nsplit covers the capacity max_pages * page), then the split merge.
extern "C" int zt_paged_decode(const void* q, const void* kpool, const void* vpool,
                               const int* block_table, const int* lengths, void* part, void* out,
                               int B, int H, int Hkv, int page, int max_pages, int D, int split_len,
                               int nsplit, long long bt_sb, long long p_sp, long long p_sh,
                               long long p_st, float scale, int dtype, void* stream) {
  using namespace zt;
  cudaGetLastError();
  if (B <= 0 || page <= 0 || max_pages <= 0 || (long long)page * max_pages > 0x7fffffffLL) return ZT_UNSUPPORTED;
  const int item = dtype == BF16 ? 2 : 4;
  const int T = page * max_pages;  // the slots a row can hold
  if (!decode_split_supported(H, Hkv, T, D, item, split_len, nsplit)) return ZT_UNSUPPORTED;
  const int G = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  const PagedKV pool = {static_cast<const char*>(kpool), static_cast<const char*>(vpool), block_table, bt_sb,
                        p_sp * item, p_sh * item, p_st * item, page};
  const long long q_sb = (long long)H * D, q_sh = D;
#define ZT_PAGED(TT)                                                                                \
  return launch_decode_split<TT, TT>(pool, q, nullptr, nullptr, lengths, pt, out, B, Hkv, T, D, G, \
                                     split_len, nsplit, q_sb, q_sh, 0, 0, scale, dtype, st)
  if (dtype == F32) { ZT_PAGED(float); }
  if (dtype == BF16) { ZT_PAGED(__nv_bfloat16); }
#undef ZT_PAGED
  return ZT_UNSUPPORTED;
}
