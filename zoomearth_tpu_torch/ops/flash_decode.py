"""K3: single-token GQA decode attention over the slot cache.

Replaces zoomearth_tpu/ops/flash_decode.py::flash_decode_attention (Pallas). The
kernel is hand-written CUDA C++ for Hopper (csrc/flash_decode.cu, whose header says
what bounds it and what its design does about it). Unlike the TPU kernel it takes
any T (no T % 512 rule) and reads a strided prefix view of the cache in place.

- `flash_decode_attention` dispatches by device: CPU -> plain version, CUDA ->
  kernel (or raises).
- `flash_decode_attention_plain` is the plain torch version, int8 algebra included.
- `live_lengths` is the launch prep: the slots each row reads (kv_len clipped to
  [0, T]); `read_bytes` is the cache traffic that follows from it.
- `decode_attention_cuda.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF, decode_attention

MAX_G = 8  # query heads per kv head (DEC_MAXG in csrc/flash_decode.cu)


def live_lengths(kv_len: torch.Tensor, T: int) -> torch.Tensor:
    """Slots each row's decode reads: kv_len clipped to [0, T] (int32)."""
    return kv_len.to(torch.int32).clamp(0, T)


def read_bytes(kv_len: torch.Tensor, T: int, Hkv: int, D: int, itemsize: int) -> int:
    """Cache bytes one K3 call reads: k and v rows of the live slots only."""
    return int(live_lengths(kv_len, T).sum()) * Hkv * D * itemsize * 2


def flash_decode_attention_plain(q, k_cache, v_cache, kv_len, ks=None, vs=None):
    """Plain torch version in fp32, cast to q.dtype. q (B, 1, H, D) or (B, H, D)."""
    had_s = q.dim() == 4
    q4 = q if had_s else q[:, None]
    T = k_cache.shape[2]
    kv_len = live_lengths(kv_len, T)
    if ks is None:
        out = decode_attention(q4.float(), k_cache.float(), v_cache.float(), kv_len=kv_len)
    else:
        B, _, H, D = q4.shape
        Hkv = k_cache.shape[1]
        qg = q4[:, 0].float().reshape(B, Hkv, H // Hkv, D)
        logits = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float())
        logits = logits * ks.float()[:, :, None, :] * D**-0.5
        valid = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]
        logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
        p = torch.softmax(logits, dim=-1) * vs.float()[:, :, None, :]
        out = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float()).reshape(B, 1, H, D)
    out = out.to(q.dtype)
    return out if had_s else out[:, 0]


def decode_attention_cuda(q, k_cache, v_cache, kv_len, ks=None, vs=None):
    """Launch K3. q (B, 1, H, D) or (B, H, D); caches (B, Hkv, T, D) of q's dtype or
    int8 (then ks/vs (B, Hkv, T) are required), unit stride on D, any other strides
    (a [:, :, :attend_len] prefix view is read in place)."""
    name = "flash_decode_attention"
    had_s = q.dim() == 4
    q3 = q[:, 0] if had_s else q
    _cuda.require_cuda(name, q3, k_cache, v_cache, kv_len, ks, vs)
    B, H, D = q3.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"{name}: k/v caches must share shape and dtype")
    if H % Hkv or H // Hkv > MAX_G or D > 128:
        raise ValueError(f"{name}: needs H / Hkv <= {MAX_G} and D <= 128 (H={H}, Hkv={Hkv}, D={D})")
    qc = _cuda.dtype_code(q3, name, (torch.float32, torch.bfloat16))
    quant = k_cache.dtype == torch.int8
    kc = _cuda.dtype_code(k_cache, name, (q3.dtype, torch.int8))
    if quant:
        if ks is None or vs is None:
            raise ValueError(f"{name}: int8 caches need ks and vs scales")
        ks = ks.float().contiguous()
        vs = vs.float().contiguous()
    else:
        ks = vs = None
    out = torch.empty((B, H, D), dtype=q3.dtype, device=q3.device)
    kv_len = live_lengths(kv_len, T).contiguous()
    rc = _cuda.lib().zt_flash_decode(
        _cuda.ptr(q3), _cuda.ptr(k_cache), _cuda.ptr(v_cache), _cuda.ptr(ks), _cuda.ptr(vs),
        _cuda.ptr(kv_len), _cuda.ptr(out), B, H, Hkv, T, D,
        q3.stride(0), q3.stride(1), k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        ks.stride(0) if quant else 0, ks.stride(1) if quant else 0,
        D**-0.5, qc, kc, _cuda.stream(q3.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(decode_attention_cuda)
    return out[:, None] if had_s else out


decode_attention_cuda.launches = 0


def flash_decode_attention(q, k_cache, v_cache, kv_len, ks=None, vs=None):
    """GQA decode attention: rows attend to their first kv_len slots. Returns the
    same rank as q, in q.dtype."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, kv_len, ks, vs)
    return decode_attention_cuda(q, k_cache, v_cache, kv_len, ks, vs)
