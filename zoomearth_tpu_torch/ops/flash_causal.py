"""K2: causal GQA attention for prefill and chunk prefill.

Replaces zoomearth_tpu/ops/flash_causal.py::flash_causal_attention (Pallas). The
kernel is hand-written CUDA C++ for Hopper (csrc/flash_causal.cu, whose header says
what bounds it and what its design does about it). Here:

- `flash_causal_attention` dispatches by device: CPU -> plain version, CUDA ->
  kernel (or raises). There is no fallback and no size threshold.
- `flash_causal_attention_plain` is the plain torch version of the same function,
  including the int8 K/V algebra.
- `causal_attention_cuda.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF, causal_attention

ROWS = 64  # (head, query) rows per kernel block: G = H / Hkv must divide it


def flash_causal_attention_plain(q, k, v, positions, kv_len, ks=None, vs=None):
    """Plain torch version in fp32, cast to q.dtype. The query at positions[b, s]
    sees kv slots t <= positions[b, s] and t < kv_len[b]. With ks/vs (B, Hkv, T), k/v
    hold int8 values: ks scales the logit columns and vs scales p before p@v."""
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    slot = torch.arange(T, device=q.device)
    valid = slot[None, :] < kv_len.to(slot.dtype)[:, None]
    if ks is None:
        out = causal_attention(
            q.float(), k.float(), v.float(), positions=positions,
            kv_positions=slot[None].expand(B, T), valid=valid,
        )
        return out.to(q.dtype)
    G = H // Hkv
    qg = q.float().reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,bktd->bkgst", qg, k.float())
    logits = logits * ks.float()[:, :, None, None, :] * D**-0.5
    mask = (slot[None, None, :] <= positions[:, :, None]) & valid[:, None, :]  # (B, S, T)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1) * vs.float()[:, :, None, None, :]
    out = torch.einsum("bkgst,bktd->bskgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def causal_attention_cuda(q, k, v, positions, kv_len, ks=None, vs=None):
    """Launch K2. q (B, S, H, D) fp32/bf16; k/v (B, Hkv, T, D) of q's dtype or int8
    (then ks/vs are required); all with unit stride on D, other strides free."""
    name = "flash_causal_attention"
    _cuda.require_cuda(name, q, k, v, positions, kv_len, ks, vs)
    B, S, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if v.shape != k.shape or v.dtype != k.dtype or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: k/v must be (B, Hkv, T, D) of one dtype")
    if H % Hkv or ROWS % (H // Hkv):
        raise ValueError(f"{name}: H / Hkv must divide {ROWS} (H={H}, Hkv={Hkv})")
    qc = _cuda.dtype_code(q, name, (torch.float32, torch.bfloat16))
    quant = k.dtype == torch.int8
    kc = _cuda.dtype_code(k, name, (q.dtype, torch.int8))
    if quant:
        if ks is None or vs is None:
            raise ValueError(f"{name}: int8 k/v need ks and vs scales")
        ks = ks.float().contiguous()
        vs = vs.float().contiguous()
    else:
        ks = vs = None
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    positions = positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    rc = _cuda.lib().zt_flash_causal(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(ks), _cuda.ptr(vs),
        _cuda.ptr(positions), _cuda.ptr(kv_len), _cuda.ptr(out), B, S, H, Hkv, T, D,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        ks.stride(0) if quant else 0, ks.stride(1) if quant else 0,
        D**-0.5, qc, kc, _cuda.stream(q.device),
    )
    _cuda.check(rc, name)
    _cuda.count_launch(causal_attention_cuda)
    return out


causal_attention_cuda.launches = 0


def flash_causal_attention(q, k, v, positions, kv_len, ks=None, vs=None):
    """Causal GQA attention over a kv-head-major (B, Hkv, T, D) cache; exact.
    positions (B, S) query slots, kv_len (B,) live slots. Returns (B, S, H, D)."""
    if q.device.type == "cpu":
        return flash_causal_attention_plain(q, k, v, positions, kv_len, ks, vs)
    return causal_attention_cuda(q, k, v, positions, kv_len, ks, vs)
