"""Batch evaluation of LRS-GRO-shaped questions through the two-stage ZoomEarth episode
on MiMo-V2.5: lrsgro_episodes.py's driver (the same inputs from the seed, the same
window of whole waves through `eval/infer.py::run_inference`, the Qwen chat template),
with MiMo-V2.5's reference (portbench/reference/mimo_v2.py, mimo_episode.py) for the
check and the model FLOPs (portbench/work/mimo_v2.py), and a launch recorder that names
each attention launch by the layers it serves: "K2" the global layers' prefills (K2 at
key width 192 and value width 128), "SWA" the window layers' prefills (K2 with the band
and the sinks) and decodes (K6 with the window), "GQA16" the global layers' decodes (K6
at 16 heads a KV head), and "MoE" the held experts' grouped products.

A traced run also starts the program's tracer for the window and reports its counters
and span totals among the readings (`attn.window`, `attn.window_keys`, `moe.*`).

The check (what decides `correct`): as lrsgro_episodes.py's, 24 of the window's
questions (the longest among them) worked out again by the fp32 reference over prompt
and served tokens, with one step for the routing near-ties of 256 sigmoid experts at
random weights, where bf16 and fp32 choose apart and the difference cascades: for each
checked pass the program runs once more, teacher-forced over the same tokens with the
reference's image embeddings (outside the window), and gives its expert choices at each
routed layer; the reference takes a token's choices where each lies within the cell's
`route_margin` (among its limits) of its own k-th best score, and keeps its own elsewhere, counting the
token (`routes_outside_margin`, limit 0). Then the served tokens' gaps are held to the
cell's limits. The fp8 control stands in the program's place the same way: the fp32
reference follows the control's own choices within the margin, judges the control's
tokens, and counts the control's choices outside it.
"""

from __future__ import annotations


import numpy as np

from ..harness.checks import logit_gap_checks
from ..harness.program import LaunchRecorder
from . import lrsgro_episodes as base
from .lrsgro_episodes_kimivl import Driver as KimiDriver

ROUTE_CHECK = "routes_outside_margin"
ROUTE_MARGIN = "route_margin"  # beside the limits in the cell file: how far a followed choice may lie


class MiMoLaunchRecorder(LaunchRecorder):
    """LaunchRecorder's replays and eager decode steps, and the eager launches of K1, K2
    (named by layer kind), K6 and the grouped expert products ("MoE")."""

    def install(self):
        from zoomearth_tpu_torch.models import moe
        from zoomearth_tpu_torch.ops import flash_causal as k2
        from zoomearth_tpu_torch.ops import flash_gqa_decode as k6

        super().install()
        for entry in [e for e in self._undo if e[1] == "causal_attention_cuda"]:  # re-wrapped below, by layer kind
            self._undo.remove(entry)
            setattr(entry[0], entry[1], entry[2])
        rec, tl = self, self.timeline

        def wrap(owner, attr, keep):
            orig = getattr(owner, attr)

            def recorded(*a, **kw):
                if not (rec.on and tl.timing()):
                    return orig(*a, **kw)
                name, args = keep(*a, **kw)
                rec.records.append((name, args))
                token = tl.begin("kernel", name)
                out = orig(*a, **kw)
                tl.end(token)
                return out

            recorded.__dict__.update(getattr(orig, "__dict__", {}))
            setattr(owner, attr, recorded)
            self._undo.append((owner, attr, orig))

        def causal(q, k, v, positions, kv_len, ks=None, vs=None, return_lse=False, window=0, sink=None):
            return ("SWA" if window else "K2"), ("attention", positions.detach().clone(), kv_len.detach().clone(),
                                                 q.shape[2], k.shape[1], q.shape[3], v.shape[3], k.shape[2], window)

        def gqa(q, k, v, kv_len, scale, window=0, sink=None):
            return ("SWA" if window else "GQA16"), ("decode", kv_len.detach().clone(), k.shape[2], q.shape[1],
                                                    k.shape[1], q.shape[2], v.shape[3], window)

        def grouped(x, w, offs):
            return "MoE", ("grouped", offs.detach().clone(), w.shape[1], w.shape[2])

        wrap(k2, "causal_attention_cuda", causal)
        wrap(k6, "gqa_decode_cuda", gqa)
        wrap(moe, "grouped_mm", grouped)

    def bounds(self, peak_flops: float, peak_bytes: float):
        import collections

        from ..work import attention as A
        from ..work import kimi_vl as K
        from ..work import mimo_v2 as M

        work = {"attention": M.attention_work, "decode": M.decode_work, "grouped": K.grouped_work}
        out = collections.Counter()
        for kernel, args in self.records:
            args = [a.cpu() if hasattr(a, "cpu") else a for a in args]
            f, b = A.segment_work(*args) if kernel == "K1" else work[args[0]](*args[1:])
            out[kernel] += max(f / peak_flops, b / peak_bytes)
        return out


class Driver(base.Driver):
    def __init__(self, cell, seed, device, spans, fault=None):
        super().__init__(cell, seed, device, spans, fault)
        if self.recorder is not None:
            self.recorder = MiMoLaunchRecorder(spans.timeline)
        self._tracer = None
        self.margin = self.cell.limits.get(ROUTE_MARGIN, 0.0)

    def setup(self, seconds: float):
        # A program without MiMo-V2.5 fails here, before any weight is drawn.
        from zoomearth_tpu_torch.models import hybrid, mimo_v2  # noqa: F401

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

    tracer_summary = KimiDriver.tracer_summary

    def model_flops(self) -> int:
        from ..reference import mimo_episode

        served = self.served()
        return sum(mimo_episode.flops(self.cfg, self.t, self.tiles[tile], s.question, bbox, *served[k])
                   for k, (s, tile, bbox) in enumerate(self.items) if k in served)

    # -- the check ------------------------------------------------------------------

    def program_routing(self, params, pcfg):
        """pass -> the program's expert choices at each routed layer over the pass's tokens:
        its decoder, teacher-forced over the whole sequence (no cache), with the pass's
        image embeddings placed by the prompt's layout."""
        import torch

        from zoomearth_tpu_torch.models import moe
        from zoomearth_tpu_torch.models.decoder import decoder_forward

        def choices(p):
            chosen = []
            route = moe.route

            def recorded(pp, cfg, x2):
                idx, w = route(pp, cfg, x2)
                chosen.append(idx)
                return idx, w

            table = params["text"]["embed"]["weight"]
            x = table[torch.as_tensor(p.ids, device=table.device)].clone()
            for img, start in zip(p.embeds, p.starts):
                x[start:start + img.shape[0]] = img.to(x.dtype)
            S = len(p.ids)
            pos = torch.arange(S, device=x.device)[None, None].expand(3, 1, S)
            moe.route = recorded
            try:
                with torch.inference_mode():
                    decoder_forward(params["text"], pcfg.text, x[None], pos)
            finally:
                moe.route = route
            return chosen

        return choices

    def check(self, control=None):
        from ..reference import mimo_episode

        served = self.served()
        missing = self.attempted - len(served)
        n = min(self.t["check_questions"], len(served))
        rng = np.random.default_rng([self.seed, 1])
        longest = max(served, key=lambda k: len(served[k][0]) + len(served[k][1])) if served else None
        picks = [] if longest is None else [longest] + [int(k) for k in rng.choice(
            [k for k in served if k != longest], size=max(0, n - 1), replace=False)]
        fam = self.cell.family()
        program = self.program_routing(fam.program_tree(self.W, self.cfg), self.pcfg)
        gaps, ctrl, mine, theirs = [], [], [], []
        for k in picks:
            sample, tile, bbox = self.items[k]
            out1, out2 = served[k]
            g, routings, c, followed = mimo_episode.gaps(self.W, self.cfg, self.t, self.tiles[tile], sample.question,
                                                         bbox, out1, out2, program, self.margin, control=control)
            gaps.append(g)
            mine += routings
            if control is not None:
                ctrl.append(c)
                theirs += followed
        limits = {name: v for name, v in self.cell.limits.items() if name not in (ROUTE_CHECK, ROUTE_MARGIN)}

        def judged(gs, routings):
            checks, readings = logit_gap_checks(limits, gs, missing)
            outside = sum(r.outside for r in routings)
            deficits = [d for r in routings for d in r.deficits]
            checks[ROUTE_CHECK] = {"value": outside, "limit": self.cell.limits.get(ROUTE_CHECK, 0)}
            readings.update(route_margin=self.margin, routes_followed=len(deficits),
                            max_route_deficit=max(deficits, default=0.0), routes_outside_margin=outside)
            return checks, readings

        checks, self.readings = judged(ctrl, theirs) if control is not None else judged(gaps, mine)
        if control is not None:
            self.program_readings = judged(gaps, mine)[1]
        if self._tracer is not None:
            self.readings["tracer"] = self.tracer_summary()
        return checks
