"""Batch evaluation of LRS-GRO-shaped questions through the two-stage ZoomEarth
episode on Kimi-VL: lrsgro_episodes.py's driver (the same inputs from the seed, the
same window of whole waves through `eval/infer.py::run_inference`), with Kimi-VL's
prompt, its reference (portbench/reference/kimi_vl.py, kimi_episode.py) for the check
and the model FLOPs (portbench/work/kimi_vl.py), and a launch recorder that also keeps
K5's launches, K2's at key width 192 and value width 128, and the grouped expert
products, for `mla_roofline.eval` and `moe_roofline.eval`.

A traced run also starts the program's tracer (zoomearth_tpu_torch/utils/profiling.py)
for the window and reports its counters and span totals among the readings, so its
`moe.*` and `mla.*` spans and counters appear in the result line.
"""

from __future__ import annotations

import collections

import numpy as np

from ..harness.checks import logit_gap_checks
from ..harness.program import LaunchRecorder
from . import lrsgro_episodes as base


class KimiLaunchRecorder(LaunchRecorder):
    """LaunchRecorder's replays and eager decode steps, and the eager launches of K1,
    K2 (its value width kept), K5 and the grouped expert products ("MoE"). Work is
    counted at the live widths of the configuration `cfg`: K1 at MoonViT's head width
    (the tower runs it zero-padded to the kernel's next width), and K2's k_r, which
    every head shares, once a slot."""

    def __init__(self, timeline, cfg: dict):
        super().__init__(timeline)
        v = cfg["vision_config"]
        self.vision_head_dim = v["hidden_size"] // v["num_attention_heads"]
        self.rope_dim = cfg["qk_rope_head_dim"]

    def install(self):
        from zoomearth_tpu_torch.models import moe
        from zoomearth_tpu_torch.ops import flash_causal as k2
        from zoomearth_tpu_torch.ops import flash_mla_decode as k5

        super().install()
        for entry in [e for e in self._undo if e[1] == "causal_attention_cuda"]:  # re-wrapped below, v's width kept
            self._undo.remove(entry)
            setattr(entry[0], entry[1], entry[2])
        rec, tl = self, self.timeline

        def wrap(owner, attr, name, keep):
            orig = getattr(owner, attr)

            def recorded(*a, **kw):
                if not (rec.on and tl.timing()):
                    return orig(*a, **kw)
                rec.records.append((name, keep(*a, **kw)))
                token = tl.begin("kernel", name)
                out = orig(*a, **kw)
                tl.end(token)
                return out

            recorded.__dict__.update(getattr(orig, "__dict__", {}))
            setattr(owner, attr, recorded)
            self._undo.append((owner, attr, orig))

        def causal(q, k, v, positions, kv_len, ks=None, vs=None, return_lse=False):
            return (positions.detach().clone(), kv_len.detach().clone(), q.shape[2], k.shape[1], q.shape[3],
                    v.shape[3], k.shape[2], q.element_size(), k.element_size())

        def latent(q, cache, kv_len, scale):
            return (kv_len.detach().clone(), cache.shape[2], q.shape[1], q.shape[2])

        def grouped(x, w, offs):
            return (offs.detach().clone(), w.shape[1], w.shape[2])

        wrap(k2, "causal_attention_cuda", "K2", causal)
        wrap(k5, "mla_decode_cuda", "K5", latent)
        wrap(moe, "grouped_mm", "MoE", grouped)

    def bounds(self, peak_flops: float, peak_bytes: float):
        from ..work import attention as A
        from ..work import kimi_vl as K

        out = collections.Counter()
        for kernel, args in self.records:
            args = [a.cpu() if hasattr(a, "cpu") else a for a in args]
            if kernel == "K1":
                seg, H, D, item = args
                f, b = A.segment_work(seg, H, min(D, self.vision_head_dim), item)
            elif kernel == "K2":
                positions, kv_len, H, Hkv, D, DV, T, item, kv_item = args
                f, b = (K.mla_prefill_work(positions, kv_len, H, Hkv, D, DV, T, self.rope_dim) if DV != D
                        else A.causal_work(positions, kv_len, H, Hkv, D, T, item, kv_item))
            elif kernel == "K5":
                kv_len, T, H, Dk = args
                f, b = K.mla_decode_work(kv_len, T, H, Dk, Dk - self.rope_dim)
            else:
                f, b = K.grouped_work(*args)
            out[kernel] += max(f / peak_flops, b / peak_bytes)
        return out


class Driver(base.Driver):
    def __init__(self, cell, seed, device, spans, fault=None):
        super().__init__(cell, seed, device, spans, fault)
        if self.recorder is not None:
            self.recorder = KimiLaunchRecorder(spans.timeline, self.cfg)
        self._tracer = None

    def setup(self, seconds: float):
        # A program without Kimi-VL fails here, before any weight is drawn.
        from zoomearth_tpu_torch.agent import prompts as PT
        from zoomearth_tpu_torch.models import mla, moe, moonvit  # noqa: F401

        PT.kimi_stage1_prompt = lambda q, _i=self.t["instruction"]: PT.KIMI_PREFIX + q + _i
        super().setup(seconds)

    def instrument(self):
        from zoomearth_tpu_torch.utils.profiling import tracer

        super().instrument()
        self._tracer = tracer
        tracer.start()

    def measure(self):
        window = super().measure()
        if self._tracer is not None:
            self._tracer.stop()
        return window

    def model_flops(self) -> int:
        from ..reference import kimi_episode

        served = self.served()
        return sum(kimi_episode.flops(self.cfg, self.t, self.tiles[tile], s.question, bbox, *served[k])
                   for k, (s, tile, bbox) in enumerate(self.items) if k in served)

    def check(self, control=None):
        from ..reference import kimi_episode

        served = self.served()
        missing = self.attempted - len(served)
        n = min(self.t["check_questions"], len(served))
        rng = np.random.default_rng([self.seed, 1])
        longest = max(served, key=lambda k: len(served[k][0]) + len(served[k][1])) if served else None
        picks = [] if longest is None else [longest] + [int(k) for k in rng.choice(
            [k for k in served if k != longest], size=max(0, n - 1), replace=False)]
        gaps, ctrl = [], []
        for k in picks:
            sample, tile, bbox = self.items[k]
            out1, out2 = served[k]
            g, c = kimi_episode.gaps(self.W, self.cfg, self.t, self.tiles[tile], sample.question, bbox, out1, out2,
                                     control=control)
            gaps.append(g)
            ctrl.append(c)
        checks, self.readings = logit_gap_checks(self.cell.limits, ctrl if control is not None else gaps, missing)
        if control is not None:
            self.program_readings = logit_gap_checks(self.cell.limits, gaps, missing)[1]
        if self._tracer is not None:
            self.readings["tracer"] = self.tracer_summary()
        return checks

    def tracer_summary(self) -> dict:
        """The program's tracer over the window: its counters, and each span's count and
        host seconds (device seconds for device spans) by name."""
        tr = self._tracer
        host, dev = collections.Counter(), collections.Counter()
        count = collections.Counter()
        for name, a, b, _ in tr.spans:
            host[name] += b - a
            count[name] += 1
        for name, a, b in tr.device:
            dev[name] += b - a
        spans = {n: {"count": count[n], "host_s": host[n], **({"device_s": dev[n]} if n in dev else {})}
                 for n in sorted(count)}
        return {"counters": dict(tr.counters), "spans": spans}
