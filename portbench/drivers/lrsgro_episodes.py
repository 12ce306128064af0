"""Batch evaluation of LRS-GRO-shaped questions through the two-stage ZoomEarth
episode: `eval/infer.py::run_inference` of the program, with the traffic file's mode.

Inputs from the seed: synthetic satellite tiles (random colour blocks), questions of
a fixed byte length grouped by tile in the traffic file's repeating pattern, and for
each question the stage-1 bbox within its tile (random weights emit none, so the
benchmark supplies it where the program parses it). Every seed gives the same sizes:
tile size, prompt lengths, crop size and budgets; only the contents differ.

The window is one call over N whole waves, N = max(min_waves, ceil(seconds / wave_s))
with the mix's `wave_s` (a wave's length on the card), so the work is fixed by the
mix and the seconds asked. The check runs the plain reference over a sample
of the finished questions (drawn from the seed, the longest among them) with their
served tokens, and reads how far each served token's logit lies below the
reference's best.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time

import numpy as np

from ..harness.checks import logit_gap_checks
from ..harness.program import LaunchRecorder
from ..harness.weights import make_weights


def make_tile(rng, px: int, block: int):
    """A px x px RGB tile of random block x block colour squares."""
    from PIL import Image

    n = px // block
    small = rng.integers(0, 256, (n, 1, n, 1, 3), dtype=np.uint8)
    return Image.fromarray(np.broadcast_to(small, (n, block, n, block, 3)).reshape(n * block, n * block, 3))


class Driver:
    def __init__(self, cell, seed, device, spans, fault=None):
        self.cell, self.seed, self.device, self.spans, self.fault = cell, seed, device, spans, fault
        self.cfg, self.t = cell.config, cell.traffic
        self.attempted = self.failed = 0
        self.recorder = LaunchRecorder(spans.timeline) if spans.enabled else None
        self.program_readings = None  # with a control: the program's own readings, beside the judged ones

    # -- inputs ---------------------------------------------------------------

    def questions(self, n: int, first_tile: int, px: int = 0):
        """n questions over consecutive tiles of px pixels (default: the mix's tile size):
        (sample, tile name, bbox), tile by tile. Question k's text and bbox depend on the
        seed and k alone."""
        from zoomearth_tpu_torch.train.data import LRSGROSample

        t = self.t
        px = px or t["tile_px"]
        pattern = t["questions_per_tile"]
        out, tile, k = [], first_tile, 0
        letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
        stem = t["question_stem"]
        while len(out) < n:
            for _ in range(min(pattern[k % len(pattern)], n - len(out))):
                rng = np.random.default_rng([self.seed, 1, first_tile, len(out)])
                word = letters[rng.integers(0, 26, t["question_bytes"] - len(stem) - 1)].tobytes().decode()
                side = rng.integers(t["bbox_side_px"][0], t["bbox_side_px"][1] + 1, 2)
                x1 = int(rng.integers(0, px - side[0]))
                y1 = int(rng.integers(0, px - side[1]))
                name = f"tile{tile:05d}"
                q = stem + word + "?"
                out.append((LRSGROSample(question_id=str(len(out)), image_name=name, category="object", question=q,
                                         higher_level="perception", ground_truth="", bbox=[], type="object"),
                            name, [x1, y1, x1 + int(side[0]), y1 + int(side[1])]))
            tile += 1
            k += 1
        return out

    def add_tiles(self, names, px: int = 0):
        for name in names:
            if name not in self.tiles:
                rng = np.random.default_rng([self.seed, 2, int(name[4:])])
                self.tiles[name] = make_tile(rng, px or self.t["tile_px"], self.t["tile_block_px"])

    # -- set-up -----------------------------------------------------------------

    def setup(self, seconds: float):
        """Weights, the program's objects, one warm-up call of one wave, then the
        window's inputs (and, traced, the instrumentation). The warm-up's tiles may be
        smaller than the window's (`warmup_tile_px`) where both are at least the stage-1
        size and the crop: the program shrinks each to the same image and cuts the same
        crop, so the device sees the same shapes for a fraction of the host's work."""
        import torch

        from zoomearth_tpu_torch.agent import episode as EP
        from zoomearth_tpu_torch.agent import prompts as PT
        from zoomearth_tpu_torch.agent.processor import Processor
        from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator
        from zoomearth_tpu_torch.tokenizer import FakeTokenizer

        fam = self.cell.family()
        dtype = getattr(torch, fam.dtype_name(self.cfg))
        self.W = make_weights(fam.leaves(self.cfg), self.seed, self.device, dtype)
        self.pcfg = fam.program_config(self.cfg)
        params = fam.program_tree(self.W, self.cfg)
        t = self.t
        self.processor = Processor(FakeTokenizer(self.pcfg.tokens), self.pcfg)
        self.generator = Generator(params, self.pcfg, max_cache_len=t["max_cache_len"],
                                   cache_dtype=getattr(torch, t.get("cache_dtype", fam.dtype_name(self.cfg))),
                                   prefill_split_rows=t.get("prefill_split_rows", 0))
        self.gen1 = GenerationConfig(max_new_tokens=t["stage1_new_tokens"], temperature=t["temperature"])
        self.gen2 = GenerationConfig(max_new_tokens=t["stage2_new_tokens"], temperature=t["temperature"])
        # The prompt the byte-level tokenizer can hold: the reference prefix, the question and the cut instruction.
        PT.stage1_prompt = lambda q, _i=t["instruction"]: PT.PREFIX + q + _i
        # Random weights emit no bbox: hand the program the question's bbox where it parses one.
        self._boxes = iter(())
        EP.extract_bboxes = lambda text, scale=1.0: [next(self._boxes)]
        self.tokens = []  # token rows per read-back, in order: stage 1, stage 2 of wave 0, ...
        gen = self.generator
        gen.trim_generated = lambda buf, _fn=gen.trim_generated: (self.tokens.append(_fn(buf)), self.tokens[-1])[1]
        if self.fault == "token":  # a token altered where it is produced (the check's own test)
            pick = gen._pick

            def altered(logits, done, rng, temperature, top_p):
                tok, d = pick(logits, done, rng, temperature, top_p)
                tok = tok.clone()
                tok[0] = (tok[0] + 7) % 256 + 32
                return tok, d

            gen._pick = altered
        self.tiles = {}
        self.out_dir = tempfile.mkdtemp(prefix="portbench_")
        B = t["batch"]
        px = t.get("warmup_tile_px", t["tile_px"])
        if px != t["tile_px"] and min(px, t["tile_px"]) < max(t["stage1_max_size"], t["crop_min_size"],
                                                              t["crop_max_size"]):
            raise ValueError("warmup_tile_px: tiles this small would give the warm-up other shapes than the window")
        warm = self.questions(B, 0, px)
        self.add_tiles((n for _, n, _ in warm), px)
        self._infer(warm)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        del self.tokens[:]
        # a fixed number of whole waves, from the seconds asked and a wave's length on the card
        self.n_waves = max(t.get("min_waves", 1), math.ceil(seconds / t["wave_s"]))
        self.items = self.questions(self.n_waves * B, 10 ** 4)
        self.add_tiles(n for _, n, _ in self.items)
        if self.spans.enabled:
            self.instrument()

    def _infer(self, items):
        from zoomearth_tpu_torch.eval.infer import run_inference

        t = self.t
        self._boxes = iter([b for _, _, b in items])
        path = os.path.join(self.out_dir, "records.jsonl")
        run_inference(self.generator, self.processor, [s for s, _, _ in items], path, batch_size=t["batch"],
                      stage1_max_size=t["stage1_max_size"], gen=self.gen1, stage2_gen=self.gen2,
                      image_loader=lambda s: self.tiles[s.image_name], mode=t["mode"])
        with open(path) as f:
            return [line for line in f if line.strip()]

    # -- the window ---------------------------------------------------------------

    def instrument(self):
        from zoomearth_tpu_torch.agent import episode as EP
        from zoomearth_tpu_torch.models import vlm

        sp, gen = self.spans, self.generator
        sp.wrap(EP, "_stage1_inputs", "host.stage1_inputs")
        sp.wrap(EP, "_stage2_continuation", "host.stage2_inputs")
        sp.wrap(vlm, "compute_vision_embeds", "vision")
        sp.wrap(gen, "run_prefill", "prefill")
        sp.wrap(gen, "run_chunk_prefill", "chunk_prefill")
        sp.device_spans = {"vision", "prefill", "chunk_prefill"}
        self.recorder.install()
        sp.wrap(gen, "run_decode", "decode")
        sp.wrap(gen, "run_decode_pair", "decode")

    def measure(self):
        import torch

        items = self.items
        steps0 = dict(self.generator.decode_steps)
        del self.tokens[:]
        if self.recorder is not None:
            self.recorder.on = True
        t0 = time.perf_counter()
        records = self._infer(items)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if self.recorder is not None:
            self.recorder.on = False
            self.recorder.uninstall()
        self.spans.unwrap()
        self.decode_steps = sum(self.generator.decode_steps.values()) - sum(steps0.values())
        self.attempted = len(items)
        self.failed = len(items) - len(records)
        self.window = (t0, t1)
        return t0, t1

    def model_flops(self) -> int:
        from ..reference import zoom_episode

        served = self.served()
        return sum(zoom_episode.flops(self.cfg, self.t, self.tiles[tile], s.question, bbox, *served[k])
                   for k, (s, tile, bbox) in enumerate(self.items) if k in served)

    def end_to_end(self, window):
        return {"questions_per_s": (self.attempted - self.failed) / (window[1] - window[0])}

    def release(self):
        import torch

        self.generator = None
        self.processor = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.out_dir, ignore_errors=True)

    # -- the check ------------------------------------------------------------------

    def served(self):
        """{question index: (stage-1 tokens, stage-2 tokens)} from the read-backs."""
        B = self.t["batch"]
        out = {}
        for w in range(len(self.tokens) // 2):
            for i, (a, b) in enumerate(zip(self.tokens[2 * w], self.tokens[2 * w + 1])):
                out[w * B + i] = (a, b)
        return out

    def check(self, control=None):
        from ..reference import zoom_episode

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
            g, c = zoom_episode.gaps(self.W, self.cfg, self.t, self.tiles[tile], sample.question, bbox, out1, out2,
                                     control=control)
            gaps.append(g)
            ctrl.append(c)
        # with a control, its gaps stand in the program's place and are judged by the same limits
        checks, self.readings = logit_gap_checks(self.cell.limits, ctrl if control is not None else gaps, missing)
        if control is not None:
            self.program_readings = logit_gap_checks(self.cell.limits, gaps, missing)[1]
        return checks
