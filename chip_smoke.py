#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (zoomearth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # the smoke: every phase below, then the two JSON lines
    python3 chip_smoke.py --profile-sft   # where a warm 3B SFT micro-step's time goes, by kernel
    python3 chip_smoke.py --tensor-grads=L,B [L,B ...]   # one SFT micro-step's gradients at the 3B widths, L
                                                         # layers and B ViT blocks, fp32 and bf16, one rank
                                                         # against two tensor ranks (1, 1, 2) sharing the card

Phases, each fatal on failure (nothing is caught). Every decode loop runs as it runs for a
user: captured (runtime.graphs), the counterpart of the reference's compiled decode programs.
A Generator call's first step runs eagerly, then its step is captured and replayed; an
engine's chunk key runs eagerly once, then replays. Each decoding phase prints the graphs it
captured, their capture time and the graphs held, and times its decode step at the path's own
shapes eagerly (the same step function, called in a loop) and captured, whose tokens must be
identical (`eager_and_captured`; the engine's chunks through whole engine runs in turns).

1. device  — exits 1 without CUDA; prints the card's name and power limit.
2. build   — compiles the hand-written kernels (csrc/*.cu) with nvcc for sm_90a.
3. kernels — K1 (segment), K2 (causal prefill / chunk prefill, int8) and K3 (decode,
   int8, strided prefix view) against their plain torch versions at the main path's
   shapes, in bf16; the int8 variants also in the forms the int8 KV cache gives them
   (K2 over the 4096-row int8 cache at prefill and, untimed, at chunk prefill; K3 over
   the [:, :, :attend_len] views of its values and of its fp32 scales, which must go
   in without a copy); Kimi-VL's cases: K5 (latent-attention decode, B = 96 over the
   [:, :, :1280] view of a 1536-slot latent cache), K2 at key width 192 and value width
   128 (prefill and the chunk over a kept prefix) and K1 at MoonViT's head width 72 (run
   zero-padded at 80), their bounds counted at the live widths: max abs error against a
   stated tolerance, and the times (CUDA
   events, timed in turns: plain, kernel, library, library, kernel, plain, ...; median
   of 10 each after 2 warm-ups each; L2 flushed before every call), per call and on
   the device (CUDA graph replays). The library call is one
   scaled_dot_product_attention on the same inputs with the mask built beforehand: a
   yardstick timed here and called nowhere in the port. Each case also gets its bound:
   the least time the card could take, the larger of its flops over 989 TFLOP/s and
   its bytes over 3.35 TB/s, both counted from the case's inputs by the `work`
   function beside the wrapper. Then, untimed, K1, K2 and K3 where they have edges:
   K2 at kv_len 0, positions either side of a tile boundary, S no multiple of 16, pad
   rows past kv_len, bf16 and int8, the transposed no-cache view and a prefix view; K1
   at segments of 16-64 rows, a boundary inside a tile, S no multiple of 128, the pad
   tail, the fused-qkv views; K3 at kv_len 0, rows ending either side of a split
   boundary, T not a whole number of splits, bf16, int8 and the strided view.
   Training's kernels at the SFT path's shapes (one cut sample: S = 8192 patches in
   segments of 5476 and 1296 and a pad tail, H = 16, D = 80; 2048 tokens, H = 16,
   Hkv = 2, D = 128, on the transposed no-cache views), timed the same way: K1's and
   K2's forwards with their lse output off and on, and their backward kernels
   (flash_segment_bwd.cu, flash_causal_bwd.cu: no TPU counterpart, the reference's
   Pallas kernels have no VJP; the variant that ran logged, the tensor-core one for these
   bf16 cases) against their plain backward, each gradient within one
   bf16 step of its largest value, beside torch.autograd.grad through one
   scaled_dot_product_attention call (its forward included: the backward needs it);
   then, untimed, the backward kernels at segments of 16-64 rows, a boundary inside a
   block, S no multiple of 32 or 128, and a K2 row with kv_len 0 (zero gradients).
4. parity  — the tiny config in fp32 on the card through every kernel (K1/K2's fp32
   variants) against the CPU plain path (which the CPU tests hold against the JAX
   package): logits and greedy tokens. Then in bf16 on the card: prefill through the
   kernels (K2's tensor-core variant) against the same weights through the plain
   versions. Then one SFT micro-step in fp32: the loss and the gradient of every
   parameter leaf through the kernels (the fp32 forward variants with lse, the
   backward kernels) against the CPU plain path.
5. slice   — Qwen2.5-VL-3B at full width with random bf16 weights from a seeded
   torch.Generator: run_inference over 8 synthetic 5000 px LRS-GRO-shaped samples
   (batch 8, greedy, 64 + 64 new tokens, forced bbox so stage 2 always runs; 16
   samples until the pipelined phase came, which now carries the longer run), then
   one run_episodes(reuse_cache=True) batch. Every record must be written and every
   kernel launched by that run, K1 and K2 through their tensor-core variants only.
6. pipelined — the same model (built once): run_inference(mode="pipelined") over 24
   samples in waves of 8 (bootstrap, two real pairs, drain), budgets 64 / 48 so that
   stage 1's solo tail runs, greedy, forced bbox; K1, K2 and K3 must launch, K1/K2
   through the tensor-core variant only, K3 twice per layer per pair step. Then the
   same 24 through run_episodes(reuse_cache=True) batch by batch for the comparison
   (wall seconds, share of identical tokens); one wave of 8 again with every
   Generator stage timed between device synchronizations (ms per pair step and per
   solo step, share of the wall time that is host preparation with the device idle);
   that wave with edges="solo" (peak memory of both edge modes); the first pair step's
   logits against the solo step's; 8 samples with Generator(cache_dtype=torch.int8),
   where K2 and K3 must take their int8 entries and nine tokens in ten must equal the
   bf16 cache's, then K2 and K3 against their plain versions on a cache that this
   path's prefill quantized, in the decoder's forms; then the scorer over the jsonl.
7. split-prefill — the Generator's two memory levers on the same weights. First the tiny
   config in fp32 on the card: prefill_split_rows=2 over 4 embeds rows gives the
   one-shot prefill's first logits (1e-5) and its greedy tokens exactly. Then the
   reference bench's big-batch shape: 96 embeds rows (random text around 8 distinct
   504 px images, whose embeddings the port's ViT computes) in the 768 bucket, a 1536-slot
   cache, one-shot against prefill_split_rows=48, in turns (one-shot, split, one-shot,
   split; the second pair kept): the prefill's wall time and its peak memory over what
   was allocated before it, K2 launched 36 times one-shot and 72 times split, the split's
   peak below the one-shot's, its first logits and every layer's cache (the valid
   slots) held row by row against the one-shot's (held_on_path's rule); K2 against its
   plain version over the last 48-row view of the split's cache (layers 0 and 35, the
   view's data pointer checked) and K3 over the attend-prefix views of the whole cache,
   random bf16 queries on the keys and values the split wrote; and after each
   a greedy decode of 32 tokens whose tokens must agree in 99 % of positions (bf16:
   cuBLAS picks its algorithms by row count). Then right_size_cache over one episode
   batch of those rows (stage 1: 160 tokens; stage 2: a 300-token text chunk and 32
   tokens), right-sized against full-size: the stage-1 cache at the bucket of
   768 + 160, grown in continue_generate, its bytes and the grown cache's printed, the
   tokens of both stages agreeing in 99 % of positions.
8. serving — the same model behind the continuous-batching ServingEngine (8 slots of
   2048, decode chunks of 8) with its pump thread running and an OpenAIServer on a free
   port: real HTTP through ChatClient (a text chat, a chat with a 512 px image, an
   over-long prompt that must come back as an error while the next request is served)
   and one SSE stream read event by event (the endpoint's tokenizer reads every id as
   a letter, since random weights pick ids the byte-level tokenizer has no text for:
   one content event for the prefill's token and one per decode chunk must arrive, not
   all at once, and spell the text chat's answer); then run_episodes_served over 16 samples on 4 tiles with
   image_keys (more episodes than slots, budgets 64 / 48, greedy, forced bbox): every
   episode must come back without error, K1, K2 and K3 must launch (K1/K2 through the
   tensor-core variant only), the prefix pool must take hits, admissions must be
   batched, compact decode chunks must run, and no slot may stay held or active. The
   same 16 on an engine with cache_dtype=torch.int8: K2's and K3's launches all
   through their int8 entries, nine tokens in ten equal to the bf16 run's. Each of the
   three engines' device routines are shadowed to keep the shapes they were called at,
   and after its run K1, K2 and K3 are held against their plain versions in every one
   of those forms on that engine's own pool: K2 over gathered rows at each (row bucket,
   length bucket), K3 over each (rows, attend span) view, gathered or in place, K1 at
   each padded patch count, bf16 and int8 with the scale rows. The scheduler's own
   containment (a failed batch retried row by row, a tick that raised in the pump) is
   counted by the engine and must read 0 throughout, and the wait for the episodes is
   bounded. The endpoint's engine also serves the data-generation pipeline
   (train/datagen.generate_records over the engine and its processor): 4 prompts x 2
   sampled generations of up to 32 tokens, every record with its 2 generations and the
   containment counts still 0. Last, the
   engine's decode step timed eagerly and captured in turns (tokens identical):
   full-width chunks with 8 live rows and compact ones with 4, on the bf16 and on the
   int8 KV cache; then captured over bf16 weights and over the int8 layout of
   ops/quant.py (which widens the weights for every product), in turns, and one decoder
   matmul at that step's shape on the device, bf16 torch.mm beside qdot.
9. training — train_sft on Qwen2.5-VL-3B at full width (random bf16 weights from a
   seeded torch.Generator, FakeTokenizer) over synthetic SFT samples on the 5000 px
   tiles: batch 1 per micro-step, 2 micro-steps to an update, cut (a 500 px bbox, a
   crop of at least 512 px) and uncut samples in turn, 4 micro-steps with a checkpoint
   every 2, then a resume from the step-2 checkpoint for 2 more with the HF export at
   its save. The one reduction: the processor's max_pixels caps each image at 448 x
   448 (1024 patches, 256 tokens), since the byte-level FakeTokenizer makes the SFT
   instruction alone 921 tokens and a sample must fit the 2048 token bucket; widths
   and depth are the 3B model's. Every parameter leaf must get a finite gradient, the
   ViT's wqkv and the decoder's wq/wk/wv nonzero ones (a detached kernel output would
   leave them 0), K1 and K2 must launch forward and backward once per block and layer
   per micro-step (all on the tensor-core variants, forward and backward), the resumed losses must
   equal the uninterrupted run's and its parameters stay within a bf16 step, and the
   export must load back equal. Seconds per micro-step (host clock, synchronized),
   tokens and patches per second and peak memory are printed.
10. grpo — GRPOTrainer on Qwen2.5-VL-3B at full width (random bf16 weights from seed 0;
   a FakeTokenizer that reads every id as a letter, since random weights pick ids the
   byte-level tokenizer has no text for and a completion without text counts as none;
   rl_prompt with its instruction cut to 80 characters) on two synthetic 5000 px
   tiles, one prompt of G = 4 rows a step, beta 0.04, epsilon 0.2, temperature 0.7,
   reuse_cache, rewards iou / format / answer plus `letter_share` (random weights earn
   no Region-Guided reward, and equal rewards give no advantage). The one reduction:
   completion budgets of 64 / 48 (the reference's 2048 / 800); widths, depth, the 512
   px stage-1 size and G are the reference's. Two full fine-tune steps at lr 1e-4 (a
   cut prompt, where stage 2 runs through K2's chunk prefill, then an uncut one): every
   gradient leaf finite and nonzero at the first, the ViT's wqkv and the decoder's
   wq/wk/wv among them, and every leaf moved after the two, except leaves that no bf16
   step of 2 lr can move (the norm scales at 1: ROADMAP §3); then a LoRA trainer (r 8,
   alpha 16, lr 1e-7): a cut step (every base bit for bit, every adapter moved, |kl| at
   the first step below 1e-3) and a cut step whose rollouts go through a ServingEngine
   of 4 slots x 2048 (stage 2 as a Continuation of the held slot; the engine's
   contained failures 0). Each step logs its seconds by stage (synchronized: stage-1
   rollout, stage-2 rollout, rewards and stitch, ref logps, loss and backward, update),
   its peak memory and its launches by kernel and variant: K1-bwd once per ViT block
   and K2-bwd once per decoder layer, K2 four times per layer on a cut step (prefill,
   chunk prefill, reference, policy) and three on an uncut one, K3 a whole number of
   layers, every bf16 K1/K2 launch forward and backward on the tensor-core variant.
   [kernels] also times K1-bwd at the cut step's ViT (8 images, S = 10368, window and
   full segments) and K2-bwd at the policy pass (B = 4, S = T = 1024), and [parity]
   holds one tiny fp32 GRPO policy step's loss, metrics and every gradient leaf on the
   card against the CPU.
11. parallel — the training paths over a (data, fsdp, tensor) mesh (parallel/), each group of
   ranks a set of subprocesses under a wall limit (parallel/launch.py: the whole group
   is killed when one rank fails, and the smoke fails), the parent holding almost
   nothing meanwhile. (a) One rank over nccl, mesh (1, 1, 1), Qwen2.5-VL-3B at full
   width and depth, [training]'s samples and settings: train_sft(mesh=) for 4
   micro-steps (2 updates: the schedule's first rate is 0) against the unsharded
   train_sft in the same process; losses, grad norms and every leaf within one bf16
   step (2^-7) of each leaf's largest value, how many bit for bit printed; K1 and K2
   forward and backward once per block and layer per micro-step, all "mma"; then one
   GRPOTrainer(mesh=) LoRA cut step ([grpo]'s settings). (b) Two ranks sharing cuda:0
   over gloo (asked for: NCCL takes no two ranks of one device; compute stays on the
   card and gloo carries each collective through host copies), the 3B widths at 27
   decoder layers and 24 ViT blocks (full attention at 7, 15 and 23; the phase's one
   reduction, so that two ranks fit in 80 GB): 4 SFT micro-steps (2 updates) over
   (1, 2, 1), whose losses, grad norms and gathered leaves must equal rank 0's
   single-process unsharded run at that depth within one bf16 step and whose
   replicated leaves and histories must be equal in bits on both ranks; one LoRA GRPO
   cut step over (1, 2, 1) (G = 2: both ranks train on every row), its replicated
   leaves equal in bits on both ranks; then
   over (2, 1, 1) one LoRA GRPO cut step (G = 4, rows 2 / 2), every leaf equal in bits
   on both ranks, and the engine tick and pair wave of the dryrun
   over the gathered weights, their greedy tokens equal on both ranks. (c) Two ranks
   sharing cuda:0 over gloo on the tensor axis, mesh (1, 1, 2), the 3B widths at full
   depth (each rank holds half of every split leaf): 4 SFT micro-steps, each rank on its
   8 ViT heads and its 8 / 1 decoder heads and half of every MLP width, held to rank
   0's unsharded run as (b) is (the leaves that start at 0, the biases, printed apart:
   after two updates they hold AdamW's +-lr steps, whose signs bf16 sums flip), replicas
   and histories equal in bits, and before it one fp32 micro-step at 4 layers and 8 ViT
   blocks whose every gathered gradient leaf must be within 1e-4 of the one-rank run's
   (bf16's own distance from fp32 is 1-6 %, so a wrong sum hides there); K1 and K1-bwd must
   run at 8 heads and K2 and K2-bwd at 8 / 1 heads once per block and layer per
   micro-step (the ViT's and the decoder's dispatchers shadowed to count calls by
   heads, captured calls skipped), all "mma"; then one LoRA GRPO cut step over (1, 1, 2)
   at G = 2, the mixed blocks: its backward K1-bwd at 8 heads (the ViT split) and
   K2-bwd at 16 / 2 (LoRA's decoder whole), replicated leaves equal in bits. Printed:
   seconds per micro-step and per step beside [training]'s and [grpo]'s, each rank's
   peak, the bytes each rank handed to collectives (parallel/collectives.traffic) and
   the launches of K1, K2 and K3 per rank. (d) Four ranks sharing cuda:0 over gloo on
   the tensor axis, mesh (1, 1, 4), where two ranks share each of the decoder's 2 KV
   heads (parallel/collectives.ShareKVHead over the mesh's KV-replica groups): one fp32
   check as (c)'s at 4 layers and 8 ViT blocks, every gathered gradient leaf of the
   first micro-step within 1e-4 and every leaf's change in L2 form within 2^-7 of the
   one-rank run's; then Qwen2.5-VL-3B at full depth and width (36 layers, 32 ViT
   blocks; rank 0's trained reference tree freed before the four ranks' trees are
   made), 4 bf16 SFT micro-steps whose losses and grad norms must be within 2^-7 of
   rank 0's unsharded run, replicas and histories equal in bits, K1 and K1-bwd at 4
   heads and K2 and K2-bwd at 4 / 1 once
   per block and layer per micro-step, all "mma", and the bytes a micro-step of each
   collective (the KV-replica groups' all-gathers and all-reduces apart). No GRPO step
   in (d): the CPU tests hold GRPO over (1, 1, 4) against the JAX trainer.
12. decode-variants — the decode-attention entry points beside the serving path, at
   the reference's shapes. First the checks: K4 (paged decode) against its plain
   version and K3 at (B=32|64, T=4096, 30 % live, pages 64|256); P1 (stream probe)
   and P2 (big-product decode) against their plain versions at B=32, T=1536; then,
   untimed, K4 and P1 at their edges: K4 at pages of 16, 64 and 256 with lengths 0,
   1, either side of a split and of a page boundary, capacity and past it, and
   block-table tails of ids far outside the pool, bf16 and fp32, against its plain
   version and K3; P1 at row blocks of 4, 2 and 1, chunks of 512 and under 64, bf16
   and fp32. Then,
   with the counts at 0, the entry points' own runs (zoomearth_tpu_torch.scripts
   probe_attn.measure and paged_256_test.measure_cell, which time each kernel beside
   its plain version in turns; P1's rate is of the cache it reads, P2's of the cache
   its row blocks walk, on device time) and a paged decode loop whose full row must
   be left unchanged; K4, P1 and P2 must each have launched. A count is of kernel runs
   through the wrapper: a call captured by runtime.graphs (the decode steps of phases
   5-8, 10, 11 and 13) counts at every replay of its graph; a call captured into the timing
   harness's own CUDA graph is not counted, nor are that graph's replays.
13. internvl — the second model family. First the tiny InternVL config in fp32 on the
   card against the CPU plain path (which the CPU tests hold against the JAX package):
   InternViT's embeddings, the embeds-path prefill logits and the greedy tokens. Then
   InternVLVLMConfig() at full width (an InternViT-300M tower: 24 blocks, width 1024,
   448 px tiles of 256 tokens; a 2-layer projector; the Qwen2.5-3B decoder), random
   bf16 weights from a seeded torch.Generator: InternVLRunner.generate over 8 synthetic
   5000 px tiles, greedy, 64 new tokens, the REC question template. The one reduction:
   max_anyres_num 8 (5 tiles an image, 40 through InternViT in one call, prompts of
   1805 tokens in the 2048 bucket) instead of the reference's 12, whose 10 tiles make a
   3085-token prompt that the reference's runner refuses. Every row must return
   tokens; K2 must launch once per decoder layer (36, all on the tensor-core variant),
   K3 a whole number of layers, K1 never; the decoder's kernel dispatchers are shadowed
   to keep the inputs of the first call of each form, and K2 and K3 are then held
   against their plain versions row by row (each query and head within one bf16 step
   of its own largest value) and timed (beside one SDPA call) at exactly those forms.
   Two planted faults must fail that check: K2 run with every row's last 64 keys
   dropped, and K3 fed kv_len - 64. The stages again, warm, through utils/profiling.tracer
   (anyres tiling on the host clock; InternViT over the 40 tiles, the prefill and decode ms a
   step from CUDA events, with no synchronization between them), the peak memory, and one
   utils/profiling.trace of a warm prefill, whose Chrome trace must hold the annotated region,
   device kernels and the tracer's host and device spans of the prefill.
14. kimi — the third family, Kimi-VL, at its published widths (vocabulary 163840, hidden
   2048, latent attention with 16 heads over a 512 + 64 latent, 64 routed experts of
   1408 with 6 chosen and 2 shared, MoonViT heads of 72) cut in depth to 3 decoder layers
   (layer 0 dense, two routed) and 2 MoonViT blocks, random bf16 weights from seed 0:
   run_inference(mode="pipelined") over 24 samples in waves of 8, budgets 64 / 48, forced
   bbox, with the plain versions of K1, K2 and K5 made to raise for the phase. Every
   record must be written; the launch counts, zeroed just before the run, must show K5
   once per layer per solo step and twice per pair step (captured replays counted), K3
   never, K1 and K2 in whole blocks and layers on the tensor-core variant only, and the
   grouped expert products. Then K5 is held row by row against its plain version at the
   inputs of the run's first K5 call (layer 0's absorbed queries over the first wave's
   stage-1 latents, through the attend view), kept as the run made them.

The second-to-last line is {"kernels": [...]} (every case of each kernel with its
time, its plain version's, the library call's where there is one, its bound and the
share of it reached; the untimed checks; launches from the path that runs it: kernel
runs through the wrapper, a captured step's counted at each replay; each K3, K4 or P2 call runs two kernels, its split pass and the
split merge; a P1 call is one memset and one kernel; a backward call runs its dq
kernel, then its dk/dv kernel, and its launches are the training phase's; the
`launches_grpo` of K1, K2, K3 and the backward kernels are the GRPO phase's, their
`launches_parallel` the parallel phase's ranks' together, the `launches_split_prefill` of K2
and K3 the split-prefill phase's, the
`launches_internvl` of K2 and K3 the InternVL phase's, the `launches_kimi` of K1, K2 and
K5 the Kimi-VL phase's); the last is the device contract line.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# bf16 roundings of attention outputs below 2: of the output, of the inputs' products and, in
# K1/K2's tensor-core variants and P2, of the softmax weights p (the kernels accumulate in fp32)
TOL_BF16 = 2e-2
# an fp32 log-sum-exp (near 9 at the SFT shapes) from the same fp32 logits, summed in another order
TOL_LSE = 1e-3
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM, dense bf16 tensor-core rate and HBM rate
LIBRARY = " (library call)"  # a case's library yardstick among an entry point's timed cases
SAMPLES, BATCH, NEW_TOKENS = 8, 8, 64
PIPE_SAMPLES, PIPE_NEW_TOKENS_2 = 24, 48  # the pipelined phase: three waves of BATCH, budgets NEW_TOKENS / 48
KIMI_LAYERS, KIMI_BLOCKS = 3, 2  # the [kimi] phase's depth: layer 0 dense, two routed layers; two MoonViT blocks
SERVE_EPISODES, SERVE_SLOTS, SERVE_SEQ_LEN, SERVE_CHUNK = 16, 8, 2048, 8  # the serving phase (budgets as pipelined)
SERVE_WAIT_S = 240  # the longest one episodes run may take; on the H100 it has taken 13 to 28 s
DATAGEN_PROMPTS = ["describe the harbour", "count the ships in the tile", "name the terrain", "where is the runway?"]
# first pair step's logits against the solo step's, bf16 at 3B width: the same arithmetic, but cuBLAS may
# choose another kernel for 16 rows than for 8, and 36 layers of bf16 roundings follow: three bf16 steps
# (2^-5) of a logit near 4.5, the largest here
TOL_PAIR_LOGITS = 0.1


def log(msg):
    print(msg, flush=True)


def errors(out, ref):
    """Largest absolute difference of each output: one for a tensor, one for each
    pair where out and ref are tuples (a forward's (out, lse), a backward's (dq, dk,
    dv))."""
    pairs = zip(out, ref) if isinstance(out, (tuple, list)) else [(out, ref)]
    return [(a.float() - b.float()).abs().max().item() for a, b in pairs]


def max_err(out, ref):
    """The largest of errors(out, ref)."""
    return max(errors(out, ref))


def within(errs, tol):
    """Whether each output's error is within its tolerance: tol is one number for
    all of them or a sequence of one per output."""
    tols = tol if isinstance(tol, (tuple, list)) else [tol] * len(errs)
    return len(tols) == len(errs) and all(e <= t for e, t in zip(errs, tols))


def fmt(x):
    """A number, one per output, or a tolerance stated in words, for the log."""
    if isinstance(x, (tuple, list)):
        return "[" + ", ".join(f"{v:.3e}" for v in x) + "]"
    return f"{x:.3e}" if isinstance(x, (int, float)) else str(x)


def all_finite(out):
    import torch

    outs = out if isinstance(out, (tuple, list)) else (out,)
    return all(bool(torch.isfinite(t.float()).all()) for t in outs)


def grad_tol(ref):
    """A backward's tolerances, one for each of dq, dk and dv: the same fp32 arithmetic
    on the same bf16 inputs summed in another order, then each gradient rounded to bf16,
    so one bf16 step (2^-7) of that gradient's own largest value."""
    return tuple(2.0 ** -7 * r.abs().max().item() for r in ref)


def library_grad_tol(ref):
    """The library backward's, one for each gradient: it may round p and ds to bf16
    between its products, so four bf16 steps (2^-5) of that gradient's largest value."""
    return tuple(2.0 ** -5 * r.abs().max().item() for r in ref)


def lse_tol(ref):
    """A forward with its lse: the output within TOL_BF16, the fp32 lse within TOL_LSE."""
    return TOL_BF16, TOL_LSE


def timing_row(label, check, times, plain_times, card, work, library_times=None, gb_per_s=None):
    """Log one kernel case (its check against its plain version, with the tolerance;
    its times from time_in_turns, per call and on the device, beside its plain
    version's and the library call's; its bound from work = (flops, bytes)) and
    return it as a row of the kernels line."""
    (ms, dev), (plain_ms, plain_dev) = times, plain_times
    flops, nbytes = work
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"
    rate = f" ({gb_per_s:.1f} GB/s on device time)" if gb_per_s else ""
    lib = "no single PyTorch call computes this"
    if library_times:
        lib = (f"library {library_times[0]:.4f} ms per call, {library_times[1]:.4f} ms device, kernel/library "
               f"{dev / library_times[1]:.3f}")
    log(f"  {label}: max_abs_err {fmt(check.get('max_abs_err_each', check['max_abs_err']))} (tol "
        f"{fmt(check['tol'])}) | per call: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, kernel/plain {ms / plain_ms:.3f} | device: kernel {dev:.4f} ms{rate}, plain "
        f"{plain_dev:.4f} ms, kernel/plain {dev / plain_dev:.3f} | {lib} | bound {bound_ms:.5f} ms by {bound_by} "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), share of bound {bound_ms / dev:.3f} | L2 cold | {card}")
    row = {"case": label, **check, "ms": ms, "plain_ms": plain_ms, "kernel_over_plain": ms / plain_ms,
           "device_ms": dev, "plain_device_ms": plain_dev, "device_kernel_over_plain": dev / plain_dev,
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / dev,
           "library_ms": library_times[0] if library_times else None,
           "library_device_ms": library_times[1] if library_times else None,
           "kernel_over_library": dev / library_times[1] if library_times else None}
    if gb_per_s:
        row["gb_per_s_device"] = gb_per_s
    return row


def sdpa(q, k, v, mask):
    """The library yardstick: one scaled_dot_product_attention call, q (B, H, S, D),
    k/v (B, Hkv, T, D), mask a boolean tensor built beforehand (True = attend)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1])


def sdpa_backends(fn):
    """Names of the SDPA backends that take this call (PyTorch picks among them itself)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ok = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                fn()
            torch.cuda.synchronize()
            ok.append(backend.name)
        except RuntimeError:
            pass
    return ok


def case(label, kernel, plain, card, work, library=None, nbytes=None, tol=None, library_tol=None, rows=False):
    """One kernel case: its output against its plain version's (max abs error within
    TOL_BF16, or within `tol(ref)`: one number, or one for each of a tuple's outputs;
    with rows=True, held row by row as held_on_path holds it), the library call's too
    where there is one (within `library_tol(ref)` where given), then all of them timed
    in turns, L2 cold: per call (CUDA events around each call) and on the device (CUDA
    graph replays)."""
    import torch

    from zoomearth_tpu_torch.scripts.timing import time_in_turns

    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    if rows:
        check = held_on_path(label, out, ref)
        check.pop("case")
        tol = check["tol"]
    else:
        errs = errors(out, ref)
        tol = TOL_BF16 if tol is None else tol(ref)
        if not (within(errs, tol) and all_finite(out)):
            raise AssertionError(f"{label}: kernel disagrees with its plain version ({errs}, tol {tol})")
        check = {"max_abs_err": max(errs), "tol": tol}
        if len(errs) > 1:
            check["max_abs_err_each"] = errs
    if library is not None:
        lib_tol = tol if library_tol is None else library_tol(ref)
        lib_errs = errors(library(), ref)
        check["library_max_abs_err"] = max(lib_errs)
        log(f"  {label}: library call vs plain version max_abs_err {fmt(lib_errs)} (tol {fmt(lib_tol)}); "
            f"SDPA backends that take it: {sdpa_backends(library)}")
        if not within(lib_errs, lib_tol):
            raise AssertionError(f"{label}: the library yardstick disagrees with the plain version")
    ms, dev = time_in_turns([plain, kernel] + ([library] if library is not None else []))
    return timing_row(label, check, (ms[1], dev[1]), (ms[0], dev[0]), card, work,
                      (ms[2], dev[2]) if library is not None else None, nbytes and nbytes / dev[1] / 1e6)


def check_kimi_kernels(card, randn):
    """Kimi-VL's kernel cases at its main path's shapes, as check_kernels' cases: K5
    over a wave's latent cache, K2 at key width 192 and value width 128 (stage-1
    prefill and the stage-2 chunk over a kept prefix), and K1 at MoonViT's head width
    72 run at 80 (zero-padded, q pre-scaled by sqrt(80 / 72)), each bound counted at
    the live widths. Returns {kernel name: [case rows]}."""
    import torch
    import torch.nn.functional as F

    from portbench.work import kimi_vl as KW
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_mla_decode as K5

    dev = torch.device("cuda")
    bf = torch.bfloat16
    # K5: one wave's stage-2 decode, B=96 rows of a 1536-slot latent cache read through its
    # attend 1280 prefix view, 1000..1280 live slots a row
    B, T, A = 96, 1536, 1280
    q = randn(B, 16, 576)
    cache = randn(B, 1, T, 576)
    view = cache[:, :, :A]
    kvl = torch.linspace(1000, A, B, device=dev).round().to(torch.int32)
    mask = (torch.arange(A, device=dev)[None] < kvl[:, None])[:, None, None]
    e5 = case(f"K5 MLA decode B={B} attend {A} of T={T}, kv_len 1000..1280",
              lambda: K5.mla_decode_cuda(q, view, kvl, 192 ** -0.5),
              lambda: K5.flash_mla_decode_plain(q, view, kvl, 192 ** -0.5), card,
              K5.work(kvl, A, 16, 576, 512),
              lambda: F.scaled_dot_product_attention(q[:, :, None], view, view[..., :512], attn_mask=mask,
                                                     scale=192 ** -0.5, enable_gqa=True)[:, :, 0])
    del cache, view, mask

    def causal_mask(pos, kvl, T):
        slot = torch.arange(T, device=dev)
        return ((slot[None, None] <= pos[:, :, None]) & (slot[None, None] < kvl[:, None, None]))[:, None]

    # K2 at 192 / 128: (a) a stage-1 prefill of 8 rows of 768 tokens; (b) the stage-2 chunk of
    # 384 tokens over kept prefixes of 700..900 slots; k = [k_n | k_r], k_r one copy a slot for all heads
    e2 = []
    for label, B, S, T, lo, hi in (("prefill B=8 S=768 T=768", 8, 768, 768, 0, 0),
                                   ("chunk B=8 S=384 T=1280, kept 700..900", 8, 384, 1280, 700, 900)):
        qm = randn(B, S, 16, 192)
        kv = randn(B, T, 16, 256)
        k = torch.cat([kv[..., :128], randn(B, T, 1, 64).expand(B, T, 16, 64)], -1).transpose(1, 2)
        v = kv[..., 128:].transpose(1, 2)
        keep = torch.linspace(lo, hi, B, device=dev).round().long()
        pos = keep[:, None] + torch.arange(S, device=dev)[None]
        kl = (keep + S).clamp(max=T).to(torch.int32)
        m = causal_mask(pos, kl, T)
        e2.append(case(f"K2 MLA {label}", lambda qm=qm, k=k, v=v, pos=pos, kl=kl: K2.causal_attention_cuda(
                           qm, k, v, pos, kl),
                       lambda qm=qm, k=k, v=v, pos=pos, kl=kl: K2.flash_causal_attention_plain(qm, k, v, pos, kl),
                       card, KW.mla_prefill_work(pos, kl, 16, 16, 192, 128, T, 64),
                       lambda qm=qm, k=k, v=v, m=m: F.scaled_dot_product_attention(
                           qm.transpose(1, 2), k, v, attn_mask=m).transpose(1, 2)))
        del qm, kv, k, v, m
    # K1 at 72 run at 80: the stage-1 MoonViT block at B=8 (8 images of 36 x 36 patches)
    S, H = 10368, 16
    seg = torch.arange(8, device=dev, dtype=torch.int32).repeat_interleave(1296)
    qkv = randn(S, 3, H, 72)
    q72, k72, v72 = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    qp, kp, vp = (F.pad(t, (0, 8)) for t in ((q72.float() * (80 / 72) ** 0.5).to(bf), k72, v72))
    sm = seg[:, None] == seg[None, :]
    e1 = case(f"K1 segment S={S} H={H} D=72 run at 80", lambda: K1.segment_attention_cuda(qp, kp, vp, seg)[..., :72],
              lambda: K1.flash_segment_attention_plain(qp, kp, vp, seg)[..., :72], card, K1.work(seg, H, 72, 2),
              lambda: sdpa(q72[None].transpose(1, 2), k72[None].transpose(1, 2), v72[None].transpose(1, 2),
                           sm)[0].transpose(0, 1))
    return {"flash_mla_decode": [e5], "flash_causal_attention": e2, "flash_segment_attention": [e1]}


def check_kernels(card):
    """Each kernel against its plain version at main-path shapes; returns ({kernel
    name: (source, TPU kernel it replaces, [case rows])}, {kernel name: untimed checks})."""
    import torch

    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(bf)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def scales(*shape):
        return (torch.rand(shape, generator=g, device=dev) * 0.02 + 0.005).to(bf)

    rows = {}
    # an int8 KV cache as the model keeps it: 4096 rows of int8 values, bf16-rounded scales in fp32
    B, Hkv, D, T = 8, 2, 128, 4096
    cache8 = (int8(B, Hkv, T, D), int8(B, Hkv, T, D), scales(B, Hkv, T).float(), scales(B, Hkv, T).float())
    # K1: stage-1 ViT full-attention block at B=8: 7 full 512 px images (1296 patches),
    # one partial image and a pad tail, S = 10368, H = 16, D = 80; q/k/v are strided
    # views of the fused qkv projection, as the ViT passes them.
    S, H, D = 10368, 16, 80
    runs = [1296] * 7 + [800]
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(runs)]
                    + [torch.full((S - sum(runs),), K1.PAD_SEG, dtype=torch.int32)]).to(dev)
    qkv = randn(S, 3, H, D)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    seg_mask = seg[:, None] == seg[None, :]
    e1 = case("K1 segment S=10368 H=16 D=80", lambda: K1.segment_attention_cuda(q, k, v, seg),
              lambda: K1.flash_segment_attention_plain(q, k, v, seg), card, K1.work(seg, H, D, 2),
              lambda: sdpa(q[None].transpose(1, 2), k[None].transpose(1, 2), v[None].transpose(1, 2),
                           seg_mask)[0].transpose(0, 1))
    del seg_mask
    rows["flash_segment_attention"] = ("zoomearth_tpu_torch/csrc/flash_segment.cu",
                                       "zoomearth_tpu/ops/flash_attention.py:92", [e1])

    def causal_mask(pos, kvl, T):
        slot = torch.arange(T, device=dev)
        return ((slot[None, None] <= pos[:, :, None]) & (slot[None, None] < kvl[:, None, None]))[:, None]

    # K2 (a): stage-1 prefill, B=8, S=512 into the 4096-row cache, kv_len = S.
    B, S, H, Hkv, D, T = 8, 512, 16, 2, 128, 4096
    q2 = randn(B, S, H, D)
    kc, vc = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    kvl = torch.full((B,), S, device=dev)
    mask_a = causal_mask(pos, kvl, T)
    e2a = case("K2 prefill B=8 S=512 T=4096", lambda: K2.causal_attention_cuda(q2, kc, vc, pos, kvl),
               lambda: K2.flash_causal_attention_plain(q2, kc, vc, pos, kvl), card,
               K2.work(pos, kvl, H, Hkv, D, T, 2),
               lambda: sdpa(q2.transpose(1, 2), kc, vc, mask_a).transpose(1, 2))
    # K2 (a) on the int8 cache: the scales go in as they are, no copy
    assert_scale_views_as_is(cache8[2], cache8[3])
    e2a8 = case("K2 prefill int8 B=8 S=512 T=4096, the cache's fp32 scales",
                lambda: K2.causal_attention_cuda(q2, cache8[0], cache8[1], pos, kvl, cache8[2], cache8[3]),
                lambda: K2.flash_causal_attention_plain(q2, cache8[0], cache8[1], pos, kvl, cache8[2], cache8[3]),
                card, K2.work(pos, kvl, H, Hkv, D, T, 2, 1))
    # K2 (b): stage-2 chunk prefill, B=8, S=384 into T=1280 at ragged keep_len.
    S, T = 384, 1280
    q3 = randn(B, S, H, D)
    kc2, vc2 = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
    keep = torch.tensor([500, 896, 640, 513, 777, 720, 600, 896], device=dev)
    pos2 = keep[:, None] + torch.arange(S, device=dev)[None]
    kvl2 = keep + S
    mask_b = causal_mask(pos2, kvl2, T)
    e2b = case("K2 chunk B=8 S=384 T=1280 ragged keep", lambda: K2.causal_attention_cuda(q3, kc2, vc2, pos2, kvl2),
               lambda: K2.flash_causal_attention_plain(q3, kc2, vc2, pos2, kvl2), card,
               K2.work(pos2, kvl2, H, Hkv, D, T, 2),
               lambda: sdpa(q3.transpose(1, 2), kc2, vc2, mask_b).transpose(1, 2))
    k8, v8, ks, vs = int8(B, Hkv, T, D), int8(B, Hkv, T, D), scales(B, Hkv, T), scales(B, Hkv, T)
    e2c = case("K2 chunk int8 K/V", lambda: K2.causal_attention_cuda(q3, k8, v8, pos2, kvl2, ks, vs),
               lambda: K2.flash_causal_attention_plain(q3, k8, v8, pos2, kvl2, ks, vs), card,
               K2.work(pos2, kvl2, H, Hkv, D, T, 2, 1))  # no single PyTorch call takes int8 K/V with scales
    rows["flash_causal_attention"] = ("zoomearth_tpu_torch/csrc/flash_causal.cu",
                                      "zoomearth_tpu/ops/flash_causal.py:124", [e2a, e2b, e2c, e2a8])

    def length_mask(kvl, T):
        return (torch.arange(T, device=dev)[None] < kvl[:, None])[:, None, None]

    # K3: decode, B=8, ragged kv_len including 1 and T.
    qd = randn(B, 1, H, D)
    e3 = []
    for T in (1280, 4096):
        kd, vd = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
        kvl3 = torch.tensor([1, T, T // 2, 700, 1000, T - 1, 3, 512], device=dev)
        m3 = length_mask(kvl3, T)
        e3.append(case(f"K3 decode B=8 T={T}", lambda: K3.decode_attention_cuda(qd, kd, vd, kvl3),
                       lambda: K3.flash_decode_attention_plain(qd, kd, vd, kvl3), card,
                       K3.work(kvl3, T, H, Hkv, D, 2), lambda: sdpa(qd.transpose(1, 2), kd, vd, m3).transpose(1, 2),
                       K3.read_bytes(kvl3, T, Hkv, D, 2)))
        if T == 1280:
            k8, v8, ks, vs = int8(B, Hkv, T, D), int8(B, Hkv, T, D), scales(B, Hkv, T), scales(B, Hkv, T)
            e3.append(case("K3 decode int8 T=1280", lambda: K3.decode_attention_cuda(qd, k8, v8, kvl3, ks, vs),
                           lambda: K3.flash_decode_attention_plain(qd, k8, v8, kvl3, ks, vs), card,
                           K3.work(kvl3, T, H, Hkv, D, 1), None, K3.read_bytes(kvl3, T, Hkv, D, 1)))
    # the decoder's [:, :, :attend_len] prefix view of the 4096-row cache, read in place
    kv_view, vv_view = kd[:, :, :1280], vd[:, :, :1280]
    kvl4 = torch.tensor([1, 1280, 640, 700, 1000, 1279, 3, 512], device=dev)
    m4 = length_mask(kvl4, 1280)
    e3.append(case("K3 decode strided attend_len=1280 view of T=4096",
                   lambda: K3.decode_attention_cuda(qd, kv_view, vv_view, kvl4),
                   lambda: K3.flash_decode_attention_plain(qd, kv_view, vv_view, kvl4), card,
                   K3.work(kvl4, 1280, H, Hkv, D, 2),
                   lambda: sdpa(qd.transpose(1, 2), kv_view, vv_view, m4).transpose(1, 2),
                   K3.read_bytes(kvl4, 1280, Hkv, D, 2)))
    # the same prefix view of the int8 cache: values and fp32 scales read in place at the 4096-row strides
    view8 = tuple(t[:, :, :1280] for t in cache8)
    assert_scale_views_as_is(view8[2], view8[3])
    e3.append(case("K3 decode int8 attend_len=1280 view of T=4096, fp32 scale views",
                   lambda: K3.decode_attention_cuda(qd, view8[0], view8[1], kvl4, view8[2], view8[3]),
                   lambda: K3.flash_decode_attention_plain(qd, view8[0], view8[1], kvl4, view8[2], view8[3]), card,
                   K3.work(kvl4, 1280, H, Hkv, D, 1), None, K3.read_bytes(kvl4, 1280, Hkv, D, 1)))
    rows["flash_decode_attention"] = ("zoomearth_tpu_torch/csrc/flash_decode.cu",
                                      "zoomearth_tpu/ops/flash_decode.py:94", e3)
    log("[kernels] Kimi-VL: K5 over the latent cache, K2 at key width 192 and value width 128, K1 at head width 72")
    kimi = check_kimi_kernels(card, randn)
    rows["flash_mla_decode"] = ("zoomearth_tpu_torch/csrc/flash_mla_decode.cu", None, kimi.pop("flash_mla_decode"))
    for name, cases in kimi.items():
        rows[name][2].extend(cases)
    log("[kernels] training: K1 and K2 forward with lse off and on, and their backward kernels, at the SFT path's shapes")
    forwards, backwards = check_training_kernels(card, randn)
    for name, cases in forwards.items():
        rows[name][2].extend(cases)
    rows.update(backwards)
    log("[kernels] GRPO: K1's and K2's backward kernels at the policy pass's shapes")
    for name, cases in check_grpo_kernels(card, randn).items():
        rows[name][2].extend(cases)
    log("[kernels] a tensor rank's heads ([parallel] (c), mesh (1, 1, 2)): K1 at 8 heads and K2 at 8 / 1, with lse, "
        "and their backward kernels")
    forwards, backwards = check_training_kernels(card, randn, heads=(8, 8, 1))
    for name, cases in {**forwards, **{n: b[2] for n, b in backwards.items()}}.items():
        rows[name][2].extend(cases)
    log("[kernels] a tensor rank's heads ([parallel] (d), mesh (1, 1, 4), two ranks to a KV head): K1 at 4 heads and "
        "K2 at 4 / 1, with lse, and their backward kernels")
    forwards, backwards = check_training_kernels(card, randn, heads=(4, 4, 1))
    for name, cases in {**forwards, **{n: b[2] for n, b in backwards.items()}}.items():
        rows[name][2].extend(cases)
    log("[kernels] untimed checks where the kernels have edges")
    return rows, {"flash_segment_attention": check_k1_edges(randn),
                  "flash_causal_attention": check_k2_edges(randn, int8, scales) + check_k2_int8_chunk(randn, cache8),
                  "flash_decode_attention": check_k3_edges(randn, int8, scales), **check_bwd_edges(randn)}


def assert_scale_views_as_is(ks, vs):
    """An int8 cache's fp32 scales, or their prefix views, must reach the kernels as they
    are (the zero-copy route of ops/_cuda.py::scale_views), not as converted copies."""
    from zoomearth_tpu_torch.ops import _cuda

    a, b = _cuda.scale_views("chip_smoke", ks, vs)
    assert a is ks and b is vs, "scale_views copied an int8 cache's fp32 scales"


def edge_check(label, out, ref, tol=TOL_BF16):
    """One untimed check (tol: one number, or one for each of a tuple's outputs): log
    and return it; raise if the kernel disagrees."""
    import torch

    torch.cuda.synchronize()
    errs = errors(out, ref)
    log(f"  {label}: max_abs_err {fmt(errs if len(errs) > 1 else errs[0])} (tol {fmt(tol)}), untimed")
    if not (within(errs, tol) and all_finite(out)):
        raise AssertionError(f"{label}: kernel disagrees with its plain version ({errs}, tol {tol})")
    return {"case": label, "max_abs_err": max(errs), "tol": tol}


ROW_TOL = "each row (one query, one head) within 2^-7 of its own largest |value| + 1e-5"


def row_ratios(out, ref):
    """Each output row's (the last dim: one query and one head) largest error over its
    tolerance, one bf16 step (2^-7) of that row's largest value plus 1e-5: at most 1
    where the kernel agrees with its plain version."""
    o, r = out.float(), ref.float()
    return (o - r).abs().amax(-1) / (2.0 ** -7 * r.abs().amax(-1) + 1e-5)


def held_on_path(label, out, ref):
    """A kernel fed the model's own keys and values, held row by row (ROW_TOL). The
    outputs' scale varies by orders between rows: a first causal row copies one value
    near 5, while a row that averages over a thousand keys holds values near 0.03. So one
    tolerance for the whole tensor is as large as a long row's values; a row's own bf16
    step is not, and a row that skips a key tile or reads a wrong slot exceeds it
    (run_internvl plants both faults and shows it). Logs and returns the check."""
    import torch

    torch.cuda.synchronize()
    ratio = row_ratios(out, ref).max().item()
    err = max_err(out, ref)
    log(f"  {label}: max_abs_err {err:.3e}, worst row's error over its tolerance {ratio:.3f} ({ROW_TOL})")
    if not (ratio <= 1 and all_finite(out)):
        raise AssertionError(f"{label}: kernel disagrees with its plain version (worst row {ratio:.3f} of its "
                             f"tolerance, max_abs_err {err})")
    return {"case": label, "max_abs_err": err, "worst_row_over_tol": ratio, "tol": ROW_TOL}


def planted_fault(label, out, ref, long_rows):
    """A negative control for held_on_path: `out` is the kernel run on inputs that make it
    skip keys its plain version sees. Fails unless the row check rejects it; returns the
    share of rows it flags, among all and among `long_rows` (a mask that broadcasts to
    the rows' shape), and whether one tolerance for the whole tensor,
    max(TOL_BF16, 2^-7 max|ref|), would have passed it."""
    import torch

    torch.cuda.synchronize()
    flagged = row_ratios(out, ref) > 1
    long_rows = long_rows.expand(flagged.shape)
    whole = max(TOL_BF16, 2.0 ** -7 * ref.float().abs().max().item())
    c = {"case": label, "rows_flagged": flagged.float().mean().item(),
         "long_rows_flagged": flagged[long_rows].float().mean().item(),
         "max_abs_err": max_err(out, ref), "whole_tensor_tol": whole,
         "whole_tensor_tol_passes_it": max_err(out, ref) <= whole}
    log(f"  planted fault, {label}: the row check flags {c['rows_flagged']:.4f} of the rows and "
        f"{c['long_rows_flagged']:.4f} of the rows over 1024 keys; max_abs_err {c['max_abs_err']:.3e} against one "
        f"whole-tensor tolerance of {whole:.3e}, which would {'pass' if c['whole_tensor_tol_passes_it'] else 'fail'} it")
    assert bool(flagged.any()), f"{label}: the row check passed a kernel that skipped keys"
    return c


def check_k1_edges(randn):
    """K1's tensor-core variant against its plain version, untimed, where it has
    edges: segments of 16-64 rows as the windowed blocks have them (every tile masked,
    boundaries inside tiles, key ranges that start mid-tile), one long segment whose
    inner tiles skip the compare, S not a multiple of 128, the PAD_SEG tail; on the
    fused-qkv views and on contiguous tensors. Returns the checks."""
    import torch

    from zoomearth_tpu_torch.ops import flash_attention as K1

    dev = torch.device("cuda")
    H, D = 16, 80
    layouts = {"windows of 16-64 rows + pad tail": [64, 16, 48, 64, 32, 64, 64, 20, 64, 64, 40, 64, 64, 64, 16, 64],
               "one 1296-row image between windows + pad tail": [40, 1296, 64, 24],
               "two segments split inside a tile, no pad": [100, 91]}
    checks = []
    before = dict(K1.segment_attention_cuda.variants)
    for label, runs in layouts.items():
        pad = 0 if "no pad" in label else 37
        S = sum(runs) + pad
        assert S % 128, S
        seg = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(runs)]
                        + [torch.full((pad,), K1.PAD_SEG, dtype=torch.int32)]).to(dev)
        qkv = randn(S, 3, H, D)
        for layout, (q, k, v) in (("fused-qkv views", (qkv[:, 0], qkv[:, 1], qkv[:, 2])),
                                  ("contiguous", tuple(qkv[:, i].contiguous() for i in range(3)))):
            out = K1.segment_attention_cuda(q, k, v, seg)
            ref = K1.flash_segment_attention_plain(q, k, v, seg)
            checks.append(edge_check(f"K1 {label}, S={S}, {layout}", out, ref))
    ran = {name: n - before[name] for name, n in K1.segment_attention_cuda.variants.items()}
    assert ran == {"mma": len(checks), "fma": 0}, f"K1 edge checks ran {ran}"
    return checks


def check_k2_edges(randn, int8, scales):
    """K2's tensor-core variant against its plain version, untimed, where it has edges:
    a row with kv_len 0 (no live key: 0, where the plain version's softmax over equal
    masked logits gives the mean of v), positions ending one before, at and after a
    tile boundary, S not a multiple of 16, pad rows whose positions exceed kv_len and
    come in no order; bf16 and int8 K/V, a prefix view of a longer cache and the
    transposed view the decoder passes without a cache. Returns the checks."""
    import torch

    from zoomearth_tpu_torch.ops import flash_causal as K2

    dev = torch.device("cuda")
    B, S, H, Hkv, D, T = 5, 40, 16, 2, 128, 300
    tile = K2.TILE
    ar = torch.arange(S, device=dev)
    pad_pos = torch.cat([100 + ar[:20], torch.tensor([299, 121, 250, 120, 5, 180, 150, 299, 122, 64] * 2, device=dev)])
    pos = torch.stack([ar, tile - S + ar, tile - S + 1 + ar, 2 * tile - S - 1 + ar, pad_pos])
    kvl = torch.tensor([0, tile, tile + 1, 2 * tile - 1, 120], device=dev)

    def expected(q, k, v, pos, kvl, a=None, b=None):
        ref = K2.flash_causal_attention_plain(q, k, v, pos, kvl, a, b)
        dead = torch.minimum(pos + 1, kvl[:, None]) <= 0
        return torch.where(dead[:, :, None, None], torch.zeros_like(ref), ref)

    q = randn(B, S, H, D)
    kf, vf = randn(B, Hkv, T + 212, D), randn(B, Hkv, T + 212, D)
    k8, v8, ks, vs = int8(B, Hkv, T, D), int8(B, Hkv, T, D), scales(B, Hkv, T), scales(B, Hkv, T)
    cases = {"bf16": (kf[:, :, :T].contiguous(), vf[:, :, :T].contiguous(), None, None),
             "int8 K/V": (k8, v8, ks, vs), "prefix view": (kf[:, :, :T], vf[:, :, :T], None, None)}
    checks = []
    before = dict(K2.causal_attention_cuda.variants)
    for label, (k, v, a, b) in cases.items():
        out = K2.causal_attention_cuda(q, k, v, pos, kvl, a, b)
        checks.append(edge_check(f"K2 {label} B={B} S={S} T={T}, kv_len {kvl.tolist()}", out,
                                 expected(q, k, v, pos, kvl, a, b)))
        assert not bool(out[0].any()), "K2: a row with kv_len 0 must give 0"
    # no cache: k/v are (B, S, Hkv, D) projections passed as transposed views, slot t is token t
    S2 = 150
    q2, k2, v2 = randn(B, S2, H, D), randn(B, S2, Hkv, D).transpose(1, 2), randn(B, S2, Hkv, D).transpose(1, 2)
    pos2 = torch.arange(S2, device=dev)[None].expand(B, S2).contiguous()
    kvl2 = torch.tensor([S2, 0, tile, tile + 1, 97], device=dev)
    out = K2.causal_attention_cuda(q2, k2, v2, pos2, kvl2)
    checks.append(edge_check(f"K2 transposed no-cache view B={B} S=T={S2}, kv_len {kvl2.tolist()}", out,
                             expected(q2, k2, v2, pos2, kvl2)))
    ran = {name: n - before[name] for name, n in K2.causal_attention_cuda.variants.items()}
    assert ran == {"mma": len(checks), "fma": 0}, f"K2 edge checks ran {ran}"
    return checks


def check_k2_int8_chunk(randn, cache8):
    """K2 as the stage-2 chunk prefill meets the int8 cache, untimed: S=384 at a ragged
    keep_len into the 4096-row cache (the continuation stays in the stage-1 cache),
    scales fp32 as the cache holds them. Returns the check."""
    import torch

    from zoomearth_tpu_torch.ops import flash_causal as K2

    dev = torch.device("cuda")
    B, S, H = 8, 384, 16
    q = randn(B, S, H, cache8[0].shape[3])
    keep = torch.tensor([500, 896, 640, 513, 777, 720, 600, 896], device=dev)
    pos = keep[:, None] + torch.arange(S, device=dev)[None]
    before = K2.causal_attention_cuda.int8_launches
    out = K2.causal_attention_cuda(q, cache8[0], cache8[1], pos, keep + S, cache8[2], cache8[3])
    assert K2.causal_attention_cuda.int8_launches == before + 1
    return [edge_check("K2 chunk int8 B=8 S=384 into the T=4096 int8 cache, ragged keep, fp32 scales", out,
                       K2.flash_causal_attention_plain(q, cache8[0], cache8[1], pos, keep + S, cache8[2], cache8[3]))]


def check_k3_edges(randn, int8, scales):
    """K3 against its plain version, untimed, where its split pass and merge have
    edges: rows with kv_len 0 (the mean of v over all T slots), rows ending one slot
    before, at and after a split boundary, and a T that is not a whole number of
    splits; bf16 and int8 K/V, and the strided prefix view. Returns the checks."""
    import torch

    from zoomearth_tpu_torch.ops import flash_decode as K3

    B, H, Hkv, D, T = 8, 16, 2, 128, 1000
    split = K3.split_plan(B, Hkv, T)[0]
    assert T % split, (T, split)
    dev = torch.device("cuda")
    q = randn(B, 1, H, D)
    kvl = torch.tensor([0, 1, split - 1, split, split + 1, 2 * split, T, 0], device=dev)
    kf, vf = randn(B, Hkv, T + 536, D), randn(B, Hkv, T + 536, D)
    k8, v8, ks, vs = int8(B, Hkv, T, D), int8(B, Hkv, T, D), scales(B, Hkv, T), scales(B, Hkv, T)
    cases = {"bf16": (kf[:, :, :T].contiguous(), vf[:, :, :T].contiguous(), None, None),
             "int8 K/V": (k8, v8, ks, vs), "strided view": (kf[:, :, :T], vf[:, :, :T], None, None)}
    checks = []
    for label, (k, v, a, b) in cases.items():
        out = K3.decode_attention_cuda(q, k, v, kvl, a, b)
        ref = K3.flash_decode_attention_plain(q, k, v, kvl, a, b)
        checks.append(edge_check(f"K3 {label} B=8 T={T} (split {split}), kv_len {kvl.tolist()}", out, ref))
    return checks


# K1 / K2 backward at the SFT path's shapes: one cut sample of 5000 px tiles as the reference trains on them
# (the tile resized to 1036 px: 5476 patches; a crop of 512 px and more: 1296 patches; the 8192 patch bucket), and
# ~2000 tokens of a real tokenizer's text in the 2048 length bucket
SFT_RUNS, SFT_PATCHES = (5476, 1296), 8192
SFT_TOKENS = 2048
BWD_NOTE = ("no TPU counterpart: the reference's Pallas kernel has no VJP (jax.grad through its pallas_call raises "
            "NotImplementedError), so the JAX package trains through XLA's autodiff of the plain attention")
NOTES = {"flash_mla_decode": "no TPU counterpart: the JAX package has no latent attention (Kimi-VL runs in the port "
                             "alone), so the CPU tests hold K5's plain version against the plain fp32 reference"}


def check_training_kernels(card, randn, heads=(16, 16, 2)):
    """K1 and K2 as training runs them, timed in turns like every other case: the
    forwards at the SFT path's shapes with lse off and on (the lse held on its own, at
    TOL_LSE), and the backward kernels against their plain backward (dq, dk and dv each
    at grad_tol), each with one library call as its yardstick (torch.autograd.grad
    through scaled_dot_product_attention with the mask built beforehand, its forward
    included: the backward needs it). The kernel's backward takes the kernel forward's
    out and lse, the plain backward the plain forward's, so a wrong lse shows here; the
    edge checks give both the kernel's. heads = (K1's H, K2's H, K2's Hkv): the model's
    (16, 16, 2), or a tensor rank's of (1, 1, 2), (8, 8, 1) ([parallel] (c)), or of
    (1, 1, 4), (4, 4, 1) ([parallel] (d): two ranks share a KV head), where only
    the forms that path runs are timed (lse on; K2-bwd's dk/dv split plan at Hkv = 1 is
    not the model's). Every variant must be the tensor-core one. Returns ({kernel name:
    [forward cases]} for K1 and K2, {backward kernel name: (source, None, [case])})."""
    import torch

    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2

    dev = torch.device("cuda")
    whole = heads == (16, 16, 2)
    rank = "" if whole else f", a tensor rank's heads of (1, 1, {16 // heads[0]})"
    S, H, D = SFT_PATCHES, heads[0], 80
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(SFT_RUNS)]
                    + [torch.full((S - sum(SFT_RUNS),), K1.PAD_SEG, dtype=torch.int32)]).to(dev)
    qkv = randn(S, 3, H, D)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    seg_mask = seg[:, None] == seg[None, :]

    def heads_first(*ts):
        return [t[None].transpose(1, 2) for t in ts]

    label = f"K1 segment SFT sample S={S} H={H} D={D} (5476 + 1296 patches + pad){rank}"
    before = dict(K1.segment_attention_cuda.variants)
    fwd1 = [case(label + ", lse off", lambda: K1.segment_attention_cuda(q, k, v, seg),
                 lambda: K1.flash_segment_attention_plain(q, k, v, seg), card, K1.work(seg, H, D, 2),
                 lambda: sdpa(*heads_first(q, k, v), seg_mask)[0].transpose(0, 1))] if whole else []
    fwd1.append(case(label + ", lse on", lambda: K1.segment_attention_cuda(q, k, v, seg, return_lse=True),
                     lambda: K1.flash_segment_attention_plain(q, k, v, seg, return_lse=True), card,
                     (K1.work(seg, H, D, 2)[0], K1.work(seg, H, D, 2)[1] + 4 * S * H), tol=lse_tol))
    fwd1[-1]["variant"] = ran_variant(K1.segment_attention_cuda, before)
    out, lse = K1.segment_attention_cuda(q, k, v, seg, return_lse=True)
    plain_out, plain_lse = K1.flash_segment_attention_plain(q, k, v, seg, return_lse=True)
    dout = randn(S, H, D)
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    before = dict(K1.segment_attention_bwd_cuda.variants)
    bwd1 = case(f"K1-bwd segment SFT sample S={S} H={H} D={D}{rank}, the plain backward from the plain forward",
                lambda: K1.segment_attention_bwd_cuda(q, k, v, seg, out, dout, lse),
                lambda: K1.flash_segment_attention_bwd_plain(q, k, v, seg, plain_out, dout, plain_lse), card,
                K1.work_bwd(seg, H, D, 2),
                lambda: torch.autograd.grad(sdpa(*heads_first(lq, lk, lv), seg_mask)[0].transpose(0, 1),
                                            (lq, lk, lv), dout),
                tol=grad_tol, library_tol=library_grad_tol)
    bwd1["variant"] = ran_variant(K1.segment_attention_bwd_cuda, before)
    del seg_mask, out, lse, plain_out, plain_lse, dout

    B, S, H, Hkv, D = 1, SFT_TOKENS, heads[1], heads[2], 128
    q2 = randn(B, S, H, D)
    kp, vp = randn(B, S, Hkv, D), randn(B, S, Hkv, D)  # the decoder's projections, passed transposed
    k2, v2 = kp.transpose(1, 2), vp.transpose(1, 2)
    pos = torch.arange(S, device=dev)[None]
    kvl = torch.tensor([S], device=dev)
    mask = (torch.arange(S, device=dev)[None, :] <= pos[0][:, None])[None, None]
    label = f"K2 no-cache SFT sample B={B} S=T={S} H={H} Hkv={Hkv} D={D}, transposed k/v views{rank}"
    before = dict(K2.causal_attention_cuda.variants)
    fwd2 = [case(label + ", lse off", lambda: K2.causal_attention_cuda(q2, k2, v2, pos, kvl),
                 lambda: K2.flash_causal_attention_plain(q2, k2, v2, pos, kvl), card,
                 K2.work(pos, kvl, H, Hkv, D, S, 2),
                 lambda: sdpa(q2.transpose(1, 2), k2, v2, mask).transpose(1, 2))] if whole else []
    fwd2.append(case(label + ", lse on", lambda: K2.causal_attention_cuda(q2, k2, v2, pos, kvl, return_lse=True),
                     lambda: K2.flash_causal_attention_plain(q2, k2, v2, pos, kvl, return_lse=True), card,
                     (K2.work(pos, kvl, H, Hkv, D, S, 2)[0], K2.work(pos, kvl, H, Hkv, D, S, 2)[1] + 4 * B * S * H),
                     tol=lse_tol))
    fwd2[-1]["variant"] = ran_variant(K2.causal_attention_cuda, before)
    out, lse = K2.causal_attention_cuda(q2, k2, v2, pos, kvl, return_lse=True)
    plain_out, plain_lse = K2.flash_causal_attention_plain(q2, k2, v2, pos, kvl, return_lse=True)
    dout = randn(B, S, H, D)
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q2, kp, vp))
    before = dict(K2.causal_attention_bwd_cuda.variants)
    bwd2 = case(f"K2-bwd no-cache SFT sample B={B} S=T={S} H={H} Hkv={Hkv} D={D}{rank}, the plain backward from the "
                "plain forward",
                lambda: K2.causal_attention_bwd_cuda(q2, k2, v2, pos, kvl, out, dout, lse),
                lambda: K2.flash_causal_attention_bwd_plain(q2, k2, v2, pos, kvl, plain_out, dout, plain_lse), card,
                K2.work_bwd(pos, kvl, H, Hkv, D, S, 2),
                lambda: (lambda g: (g[0], g[1].transpose(1, 2), g[2].transpose(1, 2)))(torch.autograd.grad(
                    sdpa(lq.transpose(1, 2), lk.transpose(1, 2), lv.transpose(1, 2), mask).transpose(1, 2),
                    (lq, lk, lv), dout)),
                tol=grad_tol, library_tol=library_grad_tol)
    bwd2["variant"] = ran_variant(K2.causal_attention_bwd_cuda, before)
    return ({"flash_segment_attention": fwd1, "flash_causal_attention": fwd2},
            {"flash_segment_attention_bwd": ("zoomearth_tpu_torch/csrc/flash_segment_bwd.cu", None, [bwd1]),
             "flash_causal_attention_bwd": ("zoomearth_tpu_torch/csrc/flash_causal_bwd.cu", None, [bwd2])})


GRPO_IMAGES, GRPO_GRID = 8, (1, 36, 36)  # a cut step's ViT: 4 rows x (stage-1 image + crop), 512 px each
GRPO_B, GRPO_TOKENS = 4, 1024  # the policy pass: G = 4 rows in the 1024 length bucket


def check_grpo_kernels(card, randn):
    """K1's and K2's backward kernels at the GRPO policy pass's shapes, timed in turns
    like the SFT cases: K1-bwd over the cut step's 8 images (S = 10368 patches, the
    window segments 28 of the 32 blocks take and the full-image segments of the other
    4, from the port's vision_metadata), K2-bwd at B = 4, S = T = 1024, kv_len = S
    (its dk/dv split plan at B = 4 is not SFT's at B = 1). Returns {backward kernel
    name: [cases]}."""
    import torch

    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models.vit import vision_metadata
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2

    dev = torch.device("cuda")
    vcfg = VLMConfig.qwen2_5_vl_3b().vision
    S = GRPO_IMAGES * GRPO_GRID[1] * GRPO_GRID[2]
    meta = vision_metadata([GRPO_GRID] * GRPO_IMAGES, vcfg, pad_to=S)
    H, D = vcfg.num_heads, vcfg.head_dim
    qkv = randn(S, 3, H, D)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def heads_first(*ts):
        return [t[None].transpose(1, 2) for t in ts]

    k1 = []
    for label, seg_np in (("window segments", meta.seg_window), ("full-image segments", meta.seg_full)):
        seg = torch.as_tensor(seg_np, dtype=torch.int32, device=dev)
        seg_mask = seg[:, None] == seg[None, :]
        out, lse = K1.segment_attention_cuda(q, k, v, seg, return_lse=True)
        plain_out, plain_lse = K1.flash_segment_attention_plain(q, k, v, seg, return_lse=True)
        dout = randn(S, H, D)
        before = dict(K1.segment_attention_bwd_cuda.variants)
        row = case(f"K1-bwd segment GRPO cut step S={S} H={H} D={D} ({GRPO_IMAGES} images, {label}), the plain "
                   "backward from the plain forward",
                   lambda: K1.segment_attention_bwd_cuda(q, k, v, seg, out, dout, lse),
                   lambda: K1.flash_segment_attention_bwd_plain(q, k, v, seg, plain_out, dout, plain_lse), card,
                   K1.work_bwd(seg, H, D, 2),
                   lambda: torch.autograd.grad(sdpa(*heads_first(lq, lk, lv), seg_mask)[0].transpose(0, 1),
                                               (lq, lk, lv), dout),
                   tol=grad_tol, library_tol=library_grad_tol)
        row["variant"] = ran_variant(K1.segment_attention_bwd_cuda, before)
        k1.append(row)
        del seg_mask, out, lse, plain_out, plain_lse, dout

    B, S, H, Hkv, D = GRPO_B, GRPO_TOKENS, 16, 2, 128
    q2 = randn(B, S, H, D)
    kp, vp = randn(B, S, Hkv, D), randn(B, S, Hkv, D)  # the decoder's projections, passed transposed
    k2, v2 = kp.transpose(1, 2), vp.transpose(1, 2)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    kvl = torch.full((B,), S, device=dev)
    mask = (torch.arange(S, device=dev)[None, :] <= torch.arange(S, device=dev)[:, None])[None, None]
    out, lse = K2.causal_attention_cuda(q2, k2, v2, pos, kvl, return_lse=True)
    plain_out, plain_lse = K2.flash_causal_attention_plain(q2, k2, v2, pos, kvl, return_lse=True)
    dout = randn(B, S, H, D)
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q2, kp, vp))
    before = dict(K2.causal_attention_bwd_cuda.variants)
    row = case(f"K2-bwd no-cache GRPO policy pass B={B} S=T={S} H={H} Hkv={Hkv} D={D}, kv_len = S, the plain "
               "backward from the plain forward",
               lambda: K2.causal_attention_bwd_cuda(q2, k2, v2, pos, kvl, out, dout, lse),
               lambda: K2.flash_causal_attention_bwd_plain(q2, k2, v2, pos, kvl, plain_out, dout, plain_lse), card,
               K2.work_bwd(pos, kvl, H, Hkv, D, S, 2),
               lambda: (lambda g: (g[0], g[1].transpose(1, 2), g[2].transpose(1, 2)))(torch.autograd.grad(
                   sdpa(lq.transpose(1, 2), lk.transpose(1, 2), lv.transpose(1, 2), mask).transpose(1, 2),
                   (lq, lk, lv), dout)),
               tol=grad_tol, library_tol=library_grad_tol)
    row["variant"] = ran_variant(K2.causal_attention_bwd_cuda, before)
    return {"flash_segment_attention_bwd": k1, "flash_causal_attention_bwd": [row]}


def ran_variant(wrapper, before):
    """The one variant a wrapper launched since `before` (its counts then), logged; at the
    SFT path's bf16 shapes it must be the tensor-core one."""
    ran = {name: n - before[name] for name, n in wrapper.variants.items()}
    log(f"  {wrapper.__name__}: launches by variant {ran} (bf16: the tensor-core kernels)")
    if ran["fma"] or not ran["mma"]:
        raise AssertionError(f"{wrapper.__name__}: bf16 at the SFT shapes must run the tensor-core variant only: {ran}")
    return "mma"


def check_bwd_edges(randn):
    """K1's and K2's backward kernels against their plain backward, untimed, where they
    have edges: K1 at segments of 16-64 rows (the windowed blocks, as training runs
    them), one long segment between windows, a boundary inside a block of 32 and S no
    multiple of 32 or 128, on the fused-qkv views; K2 on the transposed no-cache views
    with a row of kv_len 0 (zero gradients), kv_len either side of a block of keys and
    pad queries past kv_len. Returns {backward kernel name: [checks]}."""
    import torch

    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2

    dev = torch.device("cuda")
    H, D = 16, 80
    layouts = {"windows of 16-64 rows + pad tail": [64, 16, 48, 64, 32, 64, 64, 20, 64, 64, 40, 64, 64, 64, 16, 64],
               "one 1296-row image between windows + pad tail": [40, 1296, 64, 24],
               "two segments split inside a block, no pad": [100, 91]}
    k1 = []
    for label, runs in layouts.items():
        pad = 0 if "no pad" in label else 37
        S = sum(runs) + pad
        seg = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(runs)]
                        + [torch.full((pad,), K1.PAD_SEG, dtype=torch.int32)]).to(dev)
        qkv = randn(S, 3, H, D)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        out, lse = K1.segment_attention_cuda(q, k, v, seg, return_lse=True)
        dout = randn(S, H, D)
        ref = K1.flash_segment_attention_bwd_plain(q, k, v, seg, out, dout, lse)
        k1.append(edge_check(f"K1-bwd {label}, S={S}, fused-qkv views",
                             K1.segment_attention_bwd_cuda(q, k, v, seg, out, dout, lse), ref, grad_tol(ref)))
    B, S, H, Hkv, D = 5, 150, 16, 2, 128
    q = randn(B, S, H, D)
    k, v = randn(B, S, Hkv, D).transpose(1, 2), randn(B, S, Hkv, D).transpose(1, 2)
    pos = torch.arange(S, device=dev)[None].expand(B, S).contiguous()
    kvl = torch.tensor([S, 0, 64, 65, 97], device=dev)
    out, lse = K2.causal_attention_cuda(q, k, v, pos, kvl, return_lse=True)
    dout = randn(B, S, H, D)
    got = K2.causal_attention_bwd_cuda(q, k, v, pos, kvl, out, dout, lse)
    ref = K2.flash_causal_attention_bwd_plain(q, k, v, pos, kvl, out, dout, lse)
    k2 = [edge_check(f"K2-bwd transposed no-cache views B={B} S=T={S}, kv_len {kvl.tolist()}", got, ref,
                     grad_tol(ref))]
    assert not any(bool(g[1].any()) for g in got), "K2-bwd: a row with kv_len 0 must get zero gradients"
    assert got[1].stride() == k.stride(), "K2-bwd: dk must come back in k's layout"
    return {"flash_segment_attention_bwd": k1, "flash_causal_attention_bwd": k2}


def check_tiny_grad_parity():
    """The tiny config in fp32: one SFT micro-step's loss and the gradient of every
    parameter leaf on the card (K1's and K2's fp32 forward variants with lse, their
    backward kernels) against the CPU plain path, which the CPU tests hold against the
    JAX package."""
    import numpy as np
    import torch
    from PIL import Image

    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models.params import init_vlm_params, map_tree, tree_leaves
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer
    from zoomearth_tpu_torch.train import sft as TS
    from zoomearth_tpu_torch.train import sft_loop as TL
    from zoomearth_tpu_torch.train.data import SFTSample

    cfg = VLMConfig.tiny()
    processor = Processor(FakeTokenizer(cfg.tokens), cfg, max_pixels=16 * 28 * 28)
    rng = np.random.default_rng(0)
    image = Image.fromarray(rng.integers(0, 255, (700, 650, 3), dtype=np.uint8))
    samples = [SFTSample(question=f"what is at site {i}?", cut=i == 0, global_desc="An aerial scene.",
                         stage_1_reasoning="I should look closer.", area="top-left",
                         bbox=[50, 60, 200, 220] if i == 0 else [], stage_2_reasoning="It is a car.",
                         ground_truth="car", image_name="a.png") for i in range(2)]
    batch = TL.collate_sft(samples, processor, image_loader=lambda s: image)
    params = init_vlm_params(cfg, torch.Generator().manual_seed(0))
    results = []
    for device in ("cpu", "cuda"):
        p = map_tree(lambda t: t.to(device, copy=True), params)
        TL.make_trainable(p)
        before = (K1.segment_attention_bwd_cuda.launches, K2.causal_attention_bwd_cuda.launches)
        loss, n = TS.sft_loss(p, cfg, TS.batch_to_device(batch, device))
        grads = torch.autograd.grad(loss, tree_leaves(p), materialize_grads=True)
        ran = (K1.segment_attention_bwd_cuda.launches - before[0], K2.causal_attention_bwd_cuda.launches - before[1])
        results.append((float(loss.detach()), [g.cpu() for g in grads], ran))
    (lc, gc, ran_cpu), (lg, gg, ran_gpu) = results
    errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item()) for a, b in zip(gg, gc)]
    worst = max(errs)
    log(f"  tiny fp32 SFT micro-step ({batch['input_ids'].shape[1]} tokens, {batch['pixel_values'].shape[0]} patches): "
        f"loss card {lg:.6f} vs CPU {lc:.6f}; {len(errs)} gradient leaves, worst max_abs_err relative to the leaf's "
        f"largest gradient (or 1) {worst:.3e} (tol 1e-4); backward launches on the card K1 {ran_gpu[0]}, "
        f"K2 {ran_gpu[1]}, on the CPU {ran_cpu}")
    if not (abs(lg - lc) <= 1e-4 and worst <= 1e-4 and ran_cpu == (0, 0)
            and ran_gpu == (cfg.vision.depth, cfg.text.num_hidden_layers)):
        raise AssertionError("tiny-config gradient parity on the card failed")


EARLIER = {}  # [training]'s and [grpo]'s seconds and peaks, printed beside [parallel]'s
TRAIN_MICRO, TRAIN_ACCUM, TRAIN_RESUME_AT = 4, 2, 2  # micro-steps, micro-steps per update, the resume's checkpoint
TRAIN_MAX_PIXELS = 448 * 448  # each image at most 1024 patches (256 tokens): a sample fits the 2048 token bucket


def training_setup():
    """What the training phase and its profile share: Qwen2.5-VL-3B's config, the
    processor capping each image at TRAIN_MAX_PIXELS, TRAIN_MICRO synthetic SFT samples
    over two 5000 px tiles, cut and uncut in turn in the loop's order (its permutation
    of the dataset, seed 42), their image loader, and a maker of the seeded bf16 weights."""
    import numpy as np
    import torch

    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models.params import init_vlm_params
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer
    from zoomearth_tpu_torch.train.data import SFTSample

    cfg = VLMConfig.qwen2_5_vl_3b()
    processor = Processor(FakeTokenizer(cfg.tokens), cfg, max_pixels=TRAIN_MAX_PIXELS)
    tiles = {f"tile{i}.png": synthetic_tile(10 + i) for i in range(2)}
    n = TRAIN_MICRO
    order = np.random.default_rng(42).permutation(n)
    cut = np.zeros(n, bool)
    cut[order[0::2]] = True
    samples = [SFTSample(question=f"what is near the marked area {i}?", cut=bool(cut[i]),
                         global_desc="An aerial view of a harbour with piers and boats.",
                         stage_1_reasoning="The small objects near the centre need a closer look.",
                         area="center", bbox=[2250, 2250, 2750, 2750] if cut[i] else [],
                         stage_2_reasoning="The crop shows a moored ship beside the pier.",
                         ground_truth="ship", image_name=f"tile{i % 2}.png") for i in range(n)]

    def loader(s):
        return tiles[s.image_name]

    def new_params():
        return init_vlm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                               dtype=torch.bfloat16)

    return cfg, processor, samples, loader, new_params


def run_training(card):
    """SFT at Qwen2.5-VL-3B width (see the module docstring, phase 9). Three runs of
    train_sft from the same seeded weights: the uninterrupted one (TRAIN_MICRO
    micro-steps, no checkpoint: the run whose launches, times and memory are read), one
    that stops at its checkpoint (TRAIN_RESUME_AT micro-steps, saved, exported in the HF
    layout), and one that resumes from that checkpoint to the end. A machine's disk
    takes some 45 GiB of writes: one checkpoint (22.5 GB) and one export (7.5 GB) fit,
    more do not. Returns ({kernel name: {"launches_training": n}} for K1 and K2,
    {backward kernel name: launches})."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from zoomearth_tpu_torch.models.params import load_hf_checkpoint, tree_leaves
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.train import sft as TS
    from zoomearth_tpu_torch.train import sft_loop as TL
    from zoomearth_tpu_torch.train.callbacks import ExportHFCallback

    cfg, processor, samples, loader, new_params = training_setup()
    seed = 42  # the loop's order of the samples (training_setup alternates cut and uncut in it)
    sft_cfg = TS.SFTConfig(learning_rate=1e-4, warmup_steps=1, total_steps=8, weight_decay=0.01,
                           gradient_accumulation_steps=TRAIN_ACCUM)
    counters = (K1.segment_attention_cuda, K1.segment_attention_bwd_cuda, K2.causal_attention_cuda,
                K2.causal_attention_bwd_cuda)
    first = {}

    def check_first_grads(params):
        """train_sft's on_grads: the first micro-step's gradients, as the optimizer gets them."""
        index = {id(t): i for i, t in enumerate(tree_leaves(params))}
        watched = {"vision.blocks[*].attn.wqkv": [b["attn"]["wqkv"] for b in params["vision"]["blocks"]]}
        for name in ("wq", "wk", "wv"):
            watched[f"text.layers[*].attn.{name}"] = [layer["attn"][name] for layer in params["text"]["layers"]]

        def on_grads(step, grads):
            if step == 1:
                first["finite"] = int(torch.stack([torch.isfinite(g).all() for g in grads]).sum()), len(grads)
                first["nonzero"] = {name: min(float(grads[index[id(t)]].float().abs().sum()) for t in ts)
                                    for name, ts in watched.items()}
        return on_grads

    def log_steps(hist):
        for r in hist:
            log(f"  micro-step {r['step']}: {r['step_s']:.3f} s, {r['input_tokens']} tokens, {r['patches']} patches, "
                f"loss {r['loss']:.6f} | {card}")

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sft_")
    loop = TL.SFTLoopConfig(output_dir=os.path.join(out_dir, "run"), num_train_epochs=1, batch_size=1,
                            save_steps=TRAIN_MICRO + 1, log_steps=1, seed=seed)
    try:
        log(f"  the uninterrupted run: {TRAIN_MICRO} micro-steps, no checkpoint")
        params = new_params()
        on_grads = check_first_grads(params)
        for c in counters:
            c.launches = 0
        for c in counters:
            c.variants = dict.fromkeys(c.variants, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        params, hist = TL.train_sft(params, cfg, sft_cfg, loop, samples, processor, device="cuda",
                                    image_loader=loader, max_steps=TRAIN_MICRO, on_grads=on_grads)
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {c.__name__: c.launches for c in counters}
        variants = {c.__name__: dict(c.variants) for c in counters}
        log_steps(hist)
        final = tree_leaves(params)
        del params
        torch.cuda.empty_cache()

        log(f"  a run that stops at its checkpoint: {TRAIN_RESUME_AT} micro-steps, saved and exported")
        export = ExportHFCallback(export_dir=os.path.join(out_dir, "hf"), cfg=cfg, revision="smoke")
        t1 = time.time()
        saving = dataclasses.replace(loop, save_steps=TRAIN_RESUME_AT)
        saved, hist_saved = TL.train_sft(new_params(), cfg, sft_cfg, saving, samples, processor, device="cuda",
                                         image_loader=loader, max_steps=TRAIN_RESUME_AT, callbacks=[export])
        save_s = time.time() - t1
        log_steps(hist_saved)
        ckpt = os.path.join(loop.output_dir, f"checkpoint-{TRAIN_RESUME_AT}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        loaded = load_hf_checkpoint(os.path.join(out_dir, "hf", f"smoke-step{TRAIN_RESUME_AT:06d}"), cfg,
                                    device="cuda", dtype=torch.bfloat16)
        exported_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded), tree_leaves(saved)))
        del loaded, saved
        shutil.rmtree(os.path.join(out_dir, "hf"))
        torch.cuda.empty_cache()

        log(f"  the resumed run: from checkpoint-{TRAIN_RESUME_AT} to step {TRAIN_MICRO}")
        t2 = time.time()
        resumed, hist2 = TL.train_sft(new_params(), cfg, sft_cfg, dataclasses.replace(loop, resume_from_checkpoint=True),
                                      samples, processor, device="cuda", image_loader=loader,
                                      max_steps=TRAIN_MICRO - TRAIN_RESUME_AT)
        torch.cuda.synchronize()
        resume_s = time.time() - t2
        log_steps(hist2)
        same, worst = 0, 0.0
        for a, b in zip(tree_leaves(resumed), final):
            same += int(torch.equal(a, b))
            worst = max(worst, ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item())
        n_leaves = len(final)
        del resumed, final
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()

    micro = TRAIN_MICRO
    expect = {"segment_attention_cuda": cfg.vision.depth * micro, "segment_attention_bwd_cuda": cfg.vision.depth * micro,
              "causal_attention_cuda": cfg.text.num_hidden_layers * micro,
              "causal_attention_bwd_cuda": cfg.text.num_hidden_layers * micro}
    losses = [r["loss"] for r in hist]
    resumed_losses = [r["loss"] for r in hist2]
    log(f"  {n_leaves} parameter leaves; first micro-step: {first['finite'][0]} of {first['finite'][1]} gradients "
        f"finite; smallest summed |gradient| of any block's or layer's {first['nonzero']}")
    secs = sum(r["step_s"] for r in hist)
    EARLIER["training"] = {"s_per_micro_step": secs / micro, "peak_gib": peak / 2**30}
    log(f"  uninterrupted run: {micro} micro-steps ({micro // TRAIN_ACCUM} updates) in {wall:.2f} s of train_sft "
        f"wall; {secs / micro:.3f} s per micro-step, {sum(r['input_tokens'] for r in hist) / secs:.0f} tokens/s, "
        f"{sum(r['patches'] for r in hist) / secs:.0f} patches/s; peak memory allocated {peak / 2**30:.2f} GiB "
        f"({base / 2**30:.2f} GiB of it allocated before the run, the weights included) | {card}")
    log(f"  checkpoint-{TRAIN_RESUME_AT}: {ckpt_bytes / 1e9:.2f} GB; the saving run ({TRAIN_RESUME_AT} micro-steps, the "
        f"save, the HF export) {save_s:.2f} s; the resumed run (the restore, {len(hist2)} micro-steps) {resume_s:.2f} s "
        f"| {card}")
    log(f"  losses {losses}; resumed at steps {[r['step'] for r in hist2]}: {resumed_losses} "
        f"({'bit for bit' if resumed_losses == losses[TRAIN_RESUME_AT:] else 'NOT bit for bit'}); parameters after "
        f"the last update: {same} of {n_leaves} leaves bit for bit, worst leaf max |diff| / max |value| {worst:.3e}; "
        f"HF export of the checkpoint loads back {'equal' if exported_equal else 'DIFFERENT'}")
    log(f"  launches {launches} (expected {expect}); by variant, forward and backward {variants}")
    assert first["finite"][0] == first["finite"][1], "a parameter leaf has a non-finite gradient"
    assert all(v > 0 for v in first["nonzero"].values()), f"an attention leaf got no gradient: {first['nonzero']}"
    assert launches == expect, (launches, expect)
    # forward and backward: every launch on the tensor cores, never the FMA kernels
    assert all(v == {"mma": launches[name], "fma": 0} for name, v in variants.items()), variants
    assert all(np.isfinite(losses)) and len(losses) == micro
    # the loss of the same sample through the same parameters: the forward has no atomics, and the only update before
    # the checkpoint ran at the schedule's lr of 0; after the last update (its gradients summed with atomics in the
    # backward of index and index_select) each leaf within a bf16 step of its largest value
    assert resumed_losses == losses[TRAIN_RESUME_AT:], (resumed_losses, losses)
    assert worst <= 2.0 ** -7, worst
    assert exported_equal, "the HF export did not load back to the trained parameters"
    return ({"flash_segment_attention": {"launches_training": launches["segment_attention_cuda"]},
             "flash_causal_attention": {"launches_training": launches["causal_attention_cuda"]}},
            {"flash_segment_attention_bwd": launches["segment_attention_bwd_cuda"],
             "flash_causal_attention_bwd": launches["causal_attention_bwd_cuda"]})


def check_tiny_grpo_parity():
    """The tiny config in fp32: one GRPO policy step's loss, metrics and the gradient
    of every parameter leaf on the card (K1's and K2's fp32 forward variants with lse,
    their backward kernels) against the CPU plain path, on one sampled rollout batch
    made on the CPU (images, a stage-2 crop, text) with reference and old logps that
    make the KL and the clip both work."""
    import numpy as np
    import torch
    from PIL import Image

    from zoomearth_tpu_torch.agent import prompts as PT
    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models.params import init_vlm_params, map_tree, tree_leaves
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer
    from zoomearth_tpu_torch.train import grpo as TG
    from zoomearth_tpu_torch.train.data import LRSGROSample

    cfg = VLMConfig.tiny()
    tile = Image.fromarray(np.random.default_rng(0).integers(0, 255, (600, 600, 3), dtype=np.uint8))
    samples = [LRSGROSample(question_id="1", image_name="a.png", category="c", question="what?", higher_level="p",
                            ground_truth="car", bbox=[10, 10, 40, 40], type="object"),
               LRSGROSample(question_id="2", image_name="", category="m", question="1+2?", higher_level="r",
                            ground_truth="3", bbox=[], type="global")]
    trainer = TG.GRPOTrainer(
        init_vlm_params(cfg, torch.Generator().manual_seed(0)), cfg,
        TG.GRPOConfig(num_generations=2, max_completion_length=6, stage2_max_completion_length=4,
                      rollout_temperature=1.0), Processor(FakeTokenizer(cfg.tokens), cfg, max_pixels=4 * 28 * 28),
        [lambda c1, c2, **kw: [float(len(a) % 7) / 7.0 + 0.5 * (i % 2) for i, a in enumerate(c1)]],
        max_cache_len=1024, image_loader=lambda s: tile, length_buckets=(512, 768), patch_buckets=(64, 128),
        prompt_fn=lambda q: PT.PREFIX + q + "<|im_end|>\n<|im_start|>assistant\n", device="cpu")
    rb = trainer.rollout(samples, seed=0)
    rng = np.random.default_rng(1)
    rb.old_logps = (rb.ref_logps + rng.normal(0, 0.3, rb.ref_logps.shape)).astype(np.float32)
    rb.ref_logps = (rb.ref_logps + rng.normal(0, 0.1, rb.ref_logps.shape)).astype(np.float32)
    results = []
    for device in ("cpu", "cuda"):
        p = map_tree(lambda t: t.detach().to(device, copy=True).requires_grad_(), trainer.params)
        before = (K1.segment_attention_bwd_cuda.launches, K2.causal_attention_bwd_cuda.launches)
        loss, aux = TG.grpo_loss(p, cfg, TG.batch_to_device(rb, device), beta=0.04, epsilon_low=0.2,
                                 epsilon_high=0.2)
        grads = torch.autograd.grad(loss, tree_leaves(p), materialize_grads=True)
        ran = (K1.segment_attention_bwd_cuda.launches - before[0], K2.causal_attention_bwd_cuda.launches - before[1])
        results.append((float(loss.detach()), {k: float(v) for k, v in aux.items()}, [g.cpu() for g in grads], ran))
    (lc, mc, gc, ran_cpu), (lg, mg, gg, ran_gpu) = results
    errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item()) for a, b in zip(gg, gc)]
    worst = max(errs)
    metric_err = max(abs(mg[k] - mc[k]) for k in mc)
    log(f"  tiny fp32 GRPO policy step ({rb.input_ids.shape[0]} rows x {rb.input_ids.shape[1]} tokens, "
        f"{rb.pixel_values.shape[0]} patches): loss card {lg:.6f} vs CPU {lc:.6f}, metrics max |diff| {metric_err:.3e} "
        f"({sorted(mc)}); {len(errs)} gradient leaves, worst max_abs_err relative to the leaf's largest gradient "
        f"(or 1) {worst:.3e} (tol 1e-4); backward launches on the card K1 {ran_gpu[0]}, K2 {ran_gpu[1]}, on the CPU "
        f"{ran_cpu}")
    if not (abs(lg - lc) <= 1e-4 and metric_err <= 1e-4 and worst <= 1e-4 and ran_cpu == (0, 0)
            and ran_gpu == (cfg.vision.depth, cfg.text.num_hidden_layers) and mc["clip_ratio"] > 0
            and max(g.abs().max().item() for g in gc) > 1e-3):
        raise AssertionError("tiny-config GRPO gradient parity on the card failed")


GRPO_NEW_1, GRPO_NEW_2 = 64, 48  # completion budgets, stage 1 / stage 2 (the reference's 2048 / 800, cut)
GRPO_ENGINE_SLOTS, GRPO_ENGINE_SEQ = 4, 2048


def grpo_setup():
    """What the GRPO phase runs on: Qwen2.5-VL-3B's config, a processor whose tokenizer
    reads every id as a letter (legible_tokenizer), two synthetic 5000 px tiles, the
    rl_prompt template with its instruction cut to 80 characters, the Region-Guided
    rewards plus `letter_share`, and a maker of the seeded bf16 weights."""
    import torch

    from zoomearth_tpu_torch.agent import prompts as PT
    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models.params import init_vlm_params
    from zoomearth_tpu_torch.rewards.registry import get_reward_funcs
    from zoomearth_tpu_torch.train.data import LRSGROSample

    cfg = VLMConfig.qwen2_5_vl_3b()
    processor = Processor(legible_tokenizer(cfg.tokens), cfg, max_pixels=512 * 512)
    tiles = {f"tile{i}.png": synthetic_tile(20 + i) for i in range(2)}
    body = PT.INSTRUCTION.rsplit("<|im_end|>", 1)[0][:80]

    def prompt_fn(question):
        return PT.PREFIX + question + body + "<|im_end|>\n<|im_start|>assistant\n"

    def letter_share(completion1, completion2, **kw):
        """Random weights earn nothing from the Region-Guided set, and G equal rewards
        give no advantage: the share of the letters a-m in the final completion tells
        the G samples apart, so the policy gradient is not zero."""
        finals = [c2 or c1 for c1, c2 in zip(completion1, completion2)]
        return [sum(ch <= "m" for ch in f) / max(len(f), 1) for f in finals]

    names = ["iou", "format", "answer"]
    rewards = get_reward_funcs(names) + [letter_share]
    cut = LRSGROSample(question_id="1", image_name="tile0.png", category="object",
                       question="what is near the marked area?", higher_level="perception", ground_truth="ship",
                       bbox=[2200, 2200, 2380, 2350], type="object")
    uncut = LRSGROSample(question_id="2", image_name="tile1.png", category="count",
                         question="how many ships are there?", higher_level="perception", ground_truth="3",
                         bbox=[], type="global")

    def new_params():
        return init_vlm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                               dtype=torch.bfloat16)

    return cfg, processor, tiles, prompt_fn, rewards, names + ["letter_share"], cut, uncut, new_params


def bf16_step_vanishes(t, lr):
    """Whether no AdamW step of at most 2 lr (its first updates, weight decay included)
    can move any element of a bf16 leaf: every element's half-ulp (at least |x| 2^-9)
    is larger than the step. The norm scales, initialized to 1, are such leaves at lr
    1e-4 (ROADMAP §3: bf16 updates vanish)."""
    import torch

    return t.dtype == torch.bfloat16 and t.float().abs().min().item() * 2.0 ** -9 > 2 * lr


def run_grpo(card):
    """GRPO at Qwen2.5-VL-3B width (the module docstring, phase 10). Returns
    ({kernel name: {"launches_grpo": n}} for K1, K2, K3 and the backward kernels)."""
    import dataclasses

    import numpy as np
    import torch

    from zoomearth_tpu_torch.models.params import tree_leaves
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, prepare_batch
    from zoomearth_tpu_torch.serve.engine import ServingEngine
    from zoomearth_tpu_torch.train import grpo as TG
    from zoomearth_tpu_torch.train import lora as TLORA

    cfg, processor, tiles, prompt_fn, rewards, names, cut, uncut, new_params = grpo_setup()
    counters = {"flash_segment_attention": K1.segment_attention_cuda,
                "flash_segment_attention_bwd": K1.segment_attention_bwd_cuda,
                "flash_causal_attention": K2.causal_attention_cuda,
                "flash_causal_attention_bwd": K2.causal_attention_bwd_cuda,
                "flash_decode_attention": K3.decode_attention_cuda}
    with_variants = [n for n, c in counters.items() if hasattr(c, "variants")]
    total = dict.fromkeys(counters, 0)
    L, V = cfg.text.num_hidden_layers, cfg.vision.depth
    base = TG.GRPOConfig(num_generations=4, max_completion_length=GRPO_NEW_1, stage2_max_completion_length=GRPO_NEW_2,
                         rollout_temperature=0.7, learning_rate=1e-4, beta=0.04, epsilon_low=0.2, epsilon_high=0.2,
                         reuse_cache=True)

    def trainer_for(params, grpo_cfg):
        return TG.GRPOTrainer(params, cfg, grpo_cfg, processor, rewards, reward_names=names,
                              image_loader=lambda s: tiles[s.image_name], prompt_fn=prompt_fn, device="cuda",
                              time_stages=True)

    def step(trainer, label, sample, seed):
        """One step with the counts at 0: its metrics, seconds by stage, launches by kernel and variant, peak."""
        for c in counters.values():
            c.launches = 0
        for n in with_variants:
            counters[n].variants = dict.fromkeys(counters[n].variants, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        graphs0 = graph_counts(trainer.generator)
        t0 = time.perf_counter()
        m = trainer.step([sample], seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        variants = {n: dict(counters[n].variants) for n in with_variants}
        peak = torch.cuda.max_memory_allocated()
        rb = trainer._buffered
        EARLIER[label] = {"s": wall, "peak_gib": peak / 2**30}
        for n in total:
            total[n] += launches[n]
        log(f"  {label}: {wall:.3f} s; by stage (synchronized) "
            f"{ {k: round(v, 3) for k, v in trainer.stage_seconds.items()} }; {rb.input_ids.shape[0]} rows x "
            f"{rb.input_ids.shape[1]} tokens, {0 if rb.pixel_values is None else rb.pixel_values.shape[0]} patches, "
            f"stage 2 in {sum(c != '' for c in rb.completions2)} rows; peak memory allocated {peak / 2**30:.2f} GiB "
            f"| {card}")
        log(f"    metrics {m}")
        log(f"    launches {launches}; by variant {variants}; the Generator's captured decode: "
            f"{graph_line(trainer.generator, graphs0)}")
        assert all(np.isfinite(v) for v in m.values()), m
        assert all(v["fma"] == 0 and v["mma"] == launches[n] for n, v in variants.items()), variants
        if rb.pixel_values is not None:
            assert launches["flash_segment_attention_bwd"] == V, launches
        assert launches["flash_causal_attention_bwd"] == L, launches
        assert launches["flash_decode_attention"] > 0 and launches["flash_decode_attention"] % L == 0, launches
        return m, rb, launches

    # (1) the full fine-tune: a cut step (stage 2 through K2's chunk prefill), then an uncut one
    params = new_params()
    trainer = trainer_for(params, base)
    leaves = tree_leaves(trainer.params)
    before = [t.detach().clone() for t in leaves]
    first = {}

    def on_grads(grads):
        if not first:
            first["nonzero"] = int(torch.stack([g.abs().amax() > 0 for g in grads]).sum())
            first["finite"] = int(torch.stack([torch.isfinite(g).all() for g in grads]).sum())
            index = {id(t): i for i, t in enumerate(leaves)}
            watched = [b["attn"]["wqkv"] for b in trainer.params["vision"]["blocks"]]
            watched += [layer["attn"][n] for layer in trainer.params["text"]["layers"] for n in ("wq", "wk", "wv")]
            first["attention"] = min(float(grads[index[id(t)]].float().abs().sum()) for t in watched)

    trainer.on_grads = on_grads
    m1, rb1, l1 = step(trainer, "full fine-tune, cut step", cut, 1)
    assert all(c != "" for c in rb1.completions2), "stage 2 did not run on the cut step"
    assert l1["flash_causal_attention"] == 4 * L, l1  # prefill, chunk prefill, reference, policy
    m2, rb2, l2 = step(trainer, "full fine-tune, uncut step", uncut, 2)
    assert all(c == "" for c in rb2.completions2) and l2["flash_causal_attention"] == 3 * L, l2
    moved = [not torch.equal(a, b) for a, b in zip(leaves, before)]
    still = [i for i, m in enumerate(moved) if not m]
    vanish = [i for i in still if bf16_step_vanishes(leaves[i], base.learning_rate)]
    log(f"  first step's gradients: {first['nonzero']} of {len(leaves)} leaves nonzero, {first['finite']} finite, "
        f"smallest summed |gradient| of a ViT wqkv or decoder wq/wk/wv {first['attention']:.3e}; after 2 updates at lr "
        f"{base.learning_rate}: {sum(moved)} of {len(leaves)} leaves moved, {len(still)} did not, of which "
        f"{len(vanish)} are leaves no bf16 step of 2 lr can move (every |x| 2^-9 above it: the norm scales at 1)")
    assert first["nonzero"] == first["finite"] == len(leaves) and first["attention"] > 0, first
    assert still == vanish, [i for i in still if i not in vanish]
    assert all(moved[i] for i, t in enumerate(leaves) if t.dim() > 1), "a matrix did not move"
    # the rollout's decode step at its shapes (G rows, sampled), eagerly and captured
    ids = [[cfg.tokens.im_start] + [40 + (5 * r + j) % 300 for j in range(700)] for r in range(base.num_generations)]
    batch = prepare_batch(cfg, ids, [[]] * len(ids), length_buckets=(1024,), patch_buckets=(0,))
    g = trainer.generator
    logits, cache, attend = g.run_prefill(batch, max_new=GRPO_NEW_1)
    rollout = GenerationConfig(max_new_tokens=GRPO_NEW_1, temperature=base.rollout_temperature)
    eager_and_captured(f"GRPO rollout (run_decode), sampled at {base.rollout_temperature}, attend {attend}", card,
                       lambda: g.solo_step(logits, cache.clone(), batch.next_pos, rollout, seed=1, attend=attend),
                       GRPO_NEW_1)
    del logits, cache, g
    del trainer, params, leaves, before
    torch.cuda.empty_cache()

    # (2) LoRA (r 8, alpha 16) at lr 1e-7, its reference policy the adapter-disabled view: a cut step,
    # then one whose rollouts go through a ServingEngine (the held stage-1 slot continued with the crop)
    params = new_params()
    lora_cfg = dataclasses.replace(base, use_lora=True, lora_r=8, lora_alpha=16.0, learning_rate=1e-7)
    trainer = trainer_for(params, lora_cfg)
    adapted = [w for layer in trainer.params["text"]["layers"] for g in ("attn", "mlp") for w in layer[g].values()
               if TLORA.is_lora(w)]
    bases = [w["w"].detach().clone() for w in adapted]
    m3, rb3, l3 = step(trainer, "LoRA r 8 alpha 16, cut step", cut, 3)
    b_moved = sum(bool(w["b"].abs().max() > 0) for w in adapted)
    engine = ServingEngine(trainer.params, cfg, max_slots=GRPO_ENGINE_SLOTS, max_seq_len=GRPO_ENGINE_SEQ)
    trainer.rollout_engine = engine
    m4, rb4, l4 = step(trainer, f"LoRA, rollouts through a ServingEngine ({GRPO_ENGINE_SLOTS} slots x "
                       f"{GRPO_ENGINE_SEQ}), cut step", cut, 4)
    contained = {key: engine.stats.get(key, 0) for key in ("errors", "admission_retries", "pump_errors")}
    base_same = all(torch.equal(w["w"], b) for w, b in zip(adapted, bases))
    log(f"  LoRA: {len(adapted)} adapted matrices; after 2 updates the bases bit for bit: {base_same}; adapters "
        f"moved by the first update {b_moved}; |kl| at the first step {abs(m3['kl']):.3e} (tol 1e-3); engine stats "
        f"{engine.stats}, contained failures {contained}; captured decode chunks: {graph_line(engine)}")
    assert base_same and b_moved == len(adapted) and abs(m3["kl"]) < 1e-3, (base_same, b_moved, m3)
    assert all(c != "" for c in rb3.completions2 + rb4.completions2), "stage 2 did not run"
    assert not any(contained.values()) and not engine._running and not engine.held, (contained, engine.held)
    del trainer, engine, params, adapted, bases
    torch.cuda.empty_cache()
    return {n: {"launches_grpo": total[n]} for n in counters}


# [parallel] part (b)'s depth, decoder layers and ViT blocks (full attention at 7, 15, 23): at 18 / 16 the two ranks
# peaked at 20.1 and 16.2 GiB (SFT) and 22.3 GiB each (GRPO) on the H100; 27 / 24 scales that to ~31 GiB a rank, the
# deepest cut that leaves the allocator's slack and three CUDA contexts room in 80 GB
PAR_LAYERS, PAR_BLOCKS = 27, 24
PAR_MICRO = 4  # SFT micro-steps of (a) and (b): 2 updates, since the schedule's first rate is 0 and moves no leaf
# (b)'s GRPO step over (1, 2, 1): both ranks take every row, and with G = 4 both ran out of the card's memory at
# 37.6-39.5 GiB allocated each (27 / 24); G = 2 gives each rank the rows a (2, 1, 1) rank takes
PAR_FSDP_GENERATIONS = 2
# [parallel] part (c)'s depth: each rank of (1, 1, 2) holds half of every split leaf (~2.0 B parameters of 3.75 B with
# the embedding), so the full 36 layers and 32 ViT blocks
PAR_C_LAYERS, PAR_C_BLOCKS = 36, 32
PAR_C_FP32_DEPTH = (4, 8)  # (c)'s fp32 check: 4 layers, 8 ViT blocks (the full-attention block 7 among them)
PAR_C_FP32_TOL = 1e-4  # of each gradient leaf's largest value (the card's worst, 3.6e-06 at 4 / 8 and 5.7e-06 at 18 / 16)
PAR_TIMEOUT_A, PAR_TIMEOUT_B, PAR_TIMEOUT_C, PAR_TIMEOUT_D = 420, 480, 480, 420  # the groups' wall limits, seconds
GRPO_LORA_LABEL = "LoRA r 8 alpha 16, cut step"


def cut_depth(cfg, layers, blocks):
    """cfg with `layers` decoder layers and `blocks` ViT blocks (the full-attention
    blocks below `blocks` kept); every width stays."""
    import dataclasses

    vision = dataclasses.replace(cfg.vision, depth=blocks,
                                 fullatt_block_indexes=tuple(i for i in cfg.vision.fullatt_block_indexes if i < blocks))
    return dataclasses.replace(cfg, vision=vision, text=dataclasses.replace(cfg.text, num_hidden_layers=layers))


def parallel_counters():
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3

    return {"flash_segment_attention": K1.segment_attention_cuda,
            "flash_segment_attention_bwd": K1.segment_attention_bwd_cuda,
            "flash_causal_attention": K2.causal_attention_cuda,
            "flash_causal_attention_bwd": K2.causal_attention_bwd_cuda,
            "flash_decode_attention": K3.decode_attention_cuda}


def zero_counts():
    """Every [parallel] counter at 0: launches, variants, collective bytes, the peak."""
    import torch

    from zoomearth_tpu_torch.parallel import collectives

    for c in parallel_counters().values():
        c.launches = 0
        if hasattr(c, "variants"):
            c.variants = dict.fromkeys(c.variants, 0)
    collectives.traffic.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def read_counts():
    """(launches by kernel, variants by kernel, collective bytes by kind, peak GiB)."""
    import torch

    from zoomearth_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    cs = parallel_counters()
    return ({n: c.launches for n, c in cs.items()},
            {n: dict(c.variants) for n, c in cs.items() if hasattr(c, "variants")},
            dict(collectives.traffic), torch.cuda.max_memory_allocated() / 2**30)


def fingerprints(leaves):
    """One int per leaf from its bits (a position-weighted sum of its raw words, on the
    device, in chunks): equal leaves give equal numbers."""
    import torch

    out = []
    for t in leaves:
        words = t.detach().reshape(-1).view({2: torch.int16, 4: torch.int32}[t.element_size()])
        total = 0
        for i in range(0, words.numel(), 1 << 24):
            w = words[i:i + (1 << 24)].to(torch.int64)
            total += int((w * (torch.arange(i, i + w.numel(), device=w.device) % 65521 + 1)).sum())
        out.append(total)
    return out


def parallel_setup(rank, world, addr, backend):
    """A [parallel] rank: joins the group on cuda:0 and loads the kernels built by the
    parent (the same sources, so the same library)."""
    sys.path.insert(0, REPO)
    from zoomearth_tpu_torch.ops import _cuda
    from zoomearth_tpu_torch.parallel.multihost import initialize

    initialize(addr, world, rank, backend=backend, device="cuda:0")
    _cuda.build()
    _cuda.lib()


def parallel_nccl(rank, world, addr, out):
    """[parallel] part (a), one rank over nccl, mesh (1, 1, 1), the 3B model at full
    depth: train_sft(mesh=) for PAR_MICRO micro-steps against the unsharded train_sft
    on the same samples, then one GRPOTrainer(mesh=) LoRA step."""
    import gc

    import torch

    parallel_setup(rank, world, addr, "nccl")
    from zoomearth_tpu_torch.models.params import tree_leaves
    from zoomearth_tpu_torch.parallel.mesh import make_mesh
    from zoomearth_tpu_torch.train import grpo as TG
    from zoomearth_tpu_torch.train import sft as TS
    from zoomearth_tpu_torch.train import sft_loop as TL

    mesh = make_mesh()
    res = {"mesh": mesh.shape, "backend": "nccl", "devices": [str(torch.cuda.current_device())]}
    cfg, processor, samples, loader, new_params = training_setup()
    sft_cfg = TS.SFTConfig(learning_rate=1e-4, warmup_steps=1, total_steps=8, weight_decay=0.01,
                           gradient_accumulation_steps=TRAIN_ACCUM)
    loop = TL.SFTLoopConfig(output_dir=os.path.join(os.path.dirname(out), "a_sft"), num_train_epochs=1,
                            batch_size=1, save_steps=PAR_MICRO + 1, log_steps=1, seed=42)
    ref, ref_hist = TL.train_sft(new_params(), cfg, sft_cfg, loop, samples, processor, device="cuda:0",
                                 image_loader=loader, max_steps=PAR_MICRO)
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    params, hist = TL.train_sft(new_params(), cfg, sft_cfg, loop, samples, processor, mesh=mesh, device="cuda:0",
                                image_loader=loader, max_steps=PAR_MICRO)
    launches, variants, traffic, peak = read_counts()
    same, worst = 0, 0.0
    for a, b in zip(tree_leaves(params), tree_leaves(ref)):
        same += int(torch.equal(a, b))
        worst = max(worst, ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item())
    res["sft"] = {"losses": [r["loss"] for r in hist], "ref_losses": [r["loss"] for r in ref_hist],
                  "grad_norms": [r["grad_norm"] for r in hist], "ref_grad_norms": [r["grad_norm"] for r in ref_hist],
                  "step_s": [r["step_s"] for r in hist], "ref_step_s": [r["step_s"] for r in ref_hist],
                  "leaves": len(tree_leaves(ref)), "leaves_bit_equal": same, "worst_leaf_rel": worst,
                  "launches": launches, "variants": variants, "traffic": traffic, "peak_gib": peak,
                  "depth": [cfg.text.num_hidden_layers, cfg.vision.depth]}
    del params, ref
    gc.collect()
    torch.cuda.empty_cache()

    cfg, processor, tiles, prompt_fn, rewards, names, cut, uncut, new_params = grpo_setup()
    lora = TG.GRPOConfig(num_generations=4, max_completion_length=GRPO_NEW_1, stage2_max_completion_length=GRPO_NEW_2,
                         rollout_temperature=0.7, learning_rate=1e-7, beta=0.04, epsilon_low=0.2, epsilon_high=0.2,
                         reuse_cache=True, use_lora=True, lora_r=8, lora_alpha=16.0)
    trainer = TG.GRPOTrainer(new_params(), cfg, lora, processor, rewards, reward_names=names,
                             image_loader=lambda s: tiles[s.image_name], prompt_fn=prompt_fn, device="cuda",
                             time_stages=True, mesh=mesh)
    zero_counts()
    t0 = time.perf_counter()
    m = trainer.step([cut], seed=3)
    wall = time.perf_counter() - t0
    launches, variants, traffic, peak = read_counts()
    res["grpo"] = {"metrics": m, "s": wall, "stages": dict(trainer.stage_seconds), "launches": launches,
                   "variants": variants, "traffic": traffic, "peak_gib": peak,
                   "rows": int(trainer._buffered.input_ids.shape[0])}
    with open(out, "w") as f:
        json.dump(res, f)


def parallel_gloo(rank, world, addr, out_dir, layers, blocks):
    """[parallel] part (b), two ranks on cuda:0 over gloo, the 3B widths at `layers`
    decoder layers and `blocks` ViT blocks: PAR_MICRO SFT micro-steps over mesh (1, 2, 1)
    (rank 0 first runs the single-process unsharded reference, whose losses, grad norms
    and updated leaves the mesh's are held to), one LoRA GRPO step over (1, 2, 1) (G =
    PAR_FSDP_GENERATIONS; the fsdp rank's peak), then over mesh (2, 1, 1) one LoRA GRPO
    step (G = 4: rows 2 / 2), the engine tick and the pair wave over the gathered
    weights."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    parallel_setup(rank, world, addr, "gloo")
    from zoomearth_tpu_torch.models.params import init_vlm_params, tree_leaves
    from zoomearth_tpu_torch.parallel.collectives import gather_objects
    from zoomearth_tpu_torch.parallel.dryrun import serve_surfaces
    from zoomearth_tpu_torch.parallel.mesh import is_sharded, make_mesh, param_shardings, spec_leaves
    from zoomearth_tpu_torch.parallel.multihost import gather_params
    from zoomearth_tpu_torch.train import grpo as TG
    from zoomearth_tpu_torch.train import sft as TS
    from zoomearth_tpu_torch.train import sft_loop as TL

    res = {"rank": rank, "backend": "gloo", "device": f"cuda:{torch.cuda.current_device()}"}
    cfg, processor, samples, loader, _ = training_setup()
    cfg = cut_depth(cfg, layers, blocks)

    def new_params(c):
        return init_vlm_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda", dtype=torch.bfloat16)

    sft_cfg = TS.SFTConfig(learning_rate=1e-4, warmup_steps=1, total_steps=8, weight_decay=0.01,
                           gradient_accumulation_steps=TRAIN_ACCUM)
    loop = TL.SFTLoopConfig(output_dir=os.path.join(out_dir, "b_sft"), num_train_epochs=1, batch_size=1,
                            save_steps=100, log_steps=1, seed=42)
    ref_leaves = None
    if rank == 0:
        ref, ref_hist = TL.train_sft(new_params(cfg), cfg, sft_cfg, loop, samples, processor, device="cuda:0",
                                     image_loader=loader, max_steps=PAR_MICRO)
        res["sft_ref_losses"] = [r["loss"] for r in ref_hist]
        res["sft_ref_grad_norms"] = [r["grad_norm"] for r in ref_hist]
        ref_leaves = [t.detach().cpu() for t in tree_leaves(ref)]  # held on the host: the mesh run's peak is its own
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh(1, 2, 1)
    zero_counts()
    shards, hist = TL.train_sft(new_params(cfg), cfg, sft_cfg, loop, samples, processor, mesh=mesh, device="cuda:0",
                                image_loader=loader, max_steps=PAR_MICRO)
    launches, variants, traffic, peak = read_counts()
    with torch.device("meta"):
        spec_tree = param_shardings(init_vlm_params(cfg, generator=torch.Generator(), device="meta"), mesh)
    specs = spec_leaves(shards, spec_tree)
    whole = [t for t, s in zip(tree_leaves(shards), specs) if not is_sharded(s, mesh)]
    prints = gather_objects(fingerprints(whole), mesh.world_group())
    res["sft"] = {"losses": [r["loss"] for r in hist], "grad_norms": [r["grad_norm"] for r in hist],
                  "step_s": [r["step_s"] for r in hist], "launches": launches, "variants": variants,
                  "traffic": traffic, "peak_gib": peak, "replicated_leaves": len(whole),
                  "split_leaves": len(specs) - len(whole), "replicas_equal": prints[0] == prints[1],
                  "history_equal": gather_objects(hist, mesh.world_group())[0] == hist}
    # the gathered leaves after the second update against the unsharded run's, as (a) holds them
    full = gather_params(shards, spec_tree, mesh, root=0)
    if rank == 0:
        same, worst = 0, 0.0
        for a, b in zip(tree_leaves(full), ref_leaves):
            b = b.to(a.device)
            same += int(torch.equal(a, b))
            worst = max(worst, ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item())
        res["sft"].update(leaves=len(ref_leaves), leaves_bit_equal=same, worst_leaf_rel=worst)
    del shards, full, ref_leaves
    gc.collect()
    torch.cuda.empty_cache()

    cfg, processor, tiles, prompt_fn, rewards, names, cut, uncut, _ = grpo_setup()
    cfg = cut_depth(cfg, layers, blocks)
    lora = TG.GRPOConfig(num_generations=4, max_completion_length=GRPO_NEW_1, stage2_max_completion_length=GRPO_NEW_2,
                         rollout_temperature=0.7, learning_rate=1e-7, beta=0.04, epsilon_low=0.2, epsilon_high=0.2,
                         reuse_cache=True, use_lora=True, lora_r=8, lora_alpha=16.0)

    def grpo_step(mesh, generations):
        """One LoRA GRPO step over `mesh` with `generations` rows: its metrics, seconds,
        launches, peak and whether the leaves both ranks hold are equal in bits."""
        trainer = TG.GRPOTrainer(new_params(cfg), cfg, dataclasses.replace(lora, num_generations=generations),
                                 processor, rewards, reward_names=names,
                                 image_loader=lambda s: tiles[s.image_name], prompt_fn=prompt_fn, device="cuda",
                                 time_stages=True, mesh=mesh)
        zero_counts()
        t0 = time.perf_counter()
        m = trainer.step([cut], seed=3)
        wall = time.perf_counter() - t0
        launches, variants, traffic, peak = read_counts()
        held = [t for t, s in zip(tree_leaves(trainer.params), spec_leaves(trainer.params, trainer.specs))
                if not is_sharded(s, mesh)]
        prints = gather_objects(fingerprints(held), mesh.world_group())
        return trainer, {"mesh": mesh.shape, "metrics": m, "s": wall, "stages": dict(trainer.stage_seconds),
                         "launches": launches, "variants": variants, "traffic": traffic, "peak_gib": peak,
                         "rows": int(trainer._buffered.input_ids.shape[0]), "leaves_equal": prints[0] == prints[1]}

    # G = 2 over fsdp: each rank of (1, 2, 1) trains on every row, and two ranks of 4 rows do not fit in 80 GB
    trainer, res["grpo_fsdp"] = grpo_step(make_mesh(1, 2, 1), PAR_FSDP_GENERATIONS)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(2, 1, 1)
    trainer, res["grpo"] = grpo_step(mesh, 4)
    zero_counts()
    engine_tokens, stats, lengths, wave = serve_surfaces(trainer.full_params(), cfg, cache_dtype=cfg.dtype)
    launches, _, _, peak = read_counts()
    tokens = gather_objects((engine_tokens, wave), mesh.world_group())
    res["serve"] = {"engine_tokens": engine_tokens, "stats": stats, "wave_lengths": lengths,
                    "tokens_equal": tokens[0] == tokens[1], "launches": launches, "peak_gib": peak}
    with open(os.path.join(out_dir, f"b_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def head_shadows():
    """Shadow the forward dispatchers of K1 (the ViT's) and K2 (the decoder's) to count
    their calls by head counts, forward and backward (a hook on the output sees the
    gradient the backward kernel takes), skipping calls made while a CUDA graph
    captures. Returns (counts: Counter of (kernel, heads) -> calls, restore)."""
    import collections

    import torch

    from zoomearth_tpu_torch.models import decoder as DEC
    from zoomearth_tpu_torch.models import vit as VIT

    counts = collections.Counter()
    seg, causal = VIT.flash_segment_attention, DEC.flash_causal_attention

    def note(name, heads, out):
        if torch.cuda.is_current_stream_capturing():
            return
        counts[(name, heads)] += 1
        if out.requires_grad:
            out.register_hook(lambda g: counts.__setitem__((f"{name}_bwd", heads), counts[(f"{name}_bwd", heads)] + 1))

    def seg_shadow(q, k, v, s):
        out = seg(q, k, v, s)
        note("flash_segment_attention", f"{q.shape[1]}", out)
        return out

    def causal_shadow(q, k, v, *args):
        out = causal(q, k, v, *args)
        note("flash_causal_attention", f"{q.shape[2]}/{k.shape[1]}", out)
        return out

    VIT.flash_segment_attention, DEC.flash_causal_attention = seg_shadow, causal_shadow

    def restore():
        VIT.flash_segment_attention, DEC.flash_causal_attention = seg, causal

    return counts, restore


def parallel_tensor(rank, world, addr, out_dir, layers, blocks):
    """[parallel] part (c), two ranks on cuda:0 over gloo on a (1, 1, 2) mesh, the 3B
    widths at `layers` decoder layers and `blocks` ViT blocks: the fp32 check of the split
    (split_distances at PAR_C_FP32_DEPTH), then in bf16 rank 0 runs the
    single-process unsharded reference, then PAR_MICRO SFT micro-steps over the tensor
    axis (each rank its 8 heads and half the MLP widths, K1 and K2 on the local heads)
    held to it, then one LoRA GRPO cut step over (1, 1, 2) (the decoder's blocks whole,
    the ViT's and the merger split)."""
    import gc

    import torch
    import torch.distributed as dist

    parallel_setup(rank, world, addr, "gloo")
    from zoomearth_tpu_torch.models.params import init_vlm_params, tree_leaves
    from zoomearth_tpu_torch.parallel.collectives import gather_objects
    from zoomearth_tpu_torch.parallel.mesh import is_sharded, make_mesh, param_shardings, spec_leaves
    from zoomearth_tpu_torch.parallel.multihost import gather_params
    from zoomearth_tpu_torch.train import grpo as TG
    from zoomearth_tpu_torch.train import sft as TS
    from zoomearth_tpu_torch.train import sft_loop as TL

    res = {"rank": rank, "backend": "gloo", "device": f"cuda:{torch.cuda.current_device()}"}
    cfg, processor, samples, loader, _ = training_setup()
    cfg = cut_depth(cfg, layers, blocks)

    def new_params(c):
        return init_vlm_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda", dtype=torch.bfloat16)

    sft_cfg = TS.SFTConfig(learning_rate=1e-4, warmup_steps=1, total_steps=8, weight_decay=0.01,
                           gradient_accumulation_steps=TRAIN_ACCUM)
    loop = TL.SFTLoopConfig(output_dir=os.path.join(out_dir, "c_sft"), num_train_epochs=1, batch_size=1,
                            save_steps=100, log_steps=1, seed=42)
    mesh = make_mesh(1, 1, 2)

    # fp32 at full width and PAR_C_FP32_DEPTH, where rounding cannot hide a wrong sum: every gradient leaf of the
    # first micro-step and every leaf's change after the two updates, biases included, against the one-rank run's
    d = split_distances(rank, mesh, cut_depth(cfg, *PAR_C_FP32_DEPTH), torch.float32, PAR_MICRO, out_dir, processor,
                        samples, loader)
    if rank == 0:
        res["fp32"] = {"leaves": len(d["grads"]), "worst_grad_rel": max(d["grads"]),
                       "worst_grad_leaf": d["paths"][d["grads"].index(max(d["grads"]))],
                       "worst_change_rel": max(d["changes"]),
                       "worst_change_leaf": d["paths"][d["changes"].index(max(d["changes"]))],
                       "worst_change_max": max(d["changes_max"]),
                       "worst_change_max_leaf": d["paths"][d["changes_max"].index(max(d["changes_max"]))],
                       "depth": list(PAR_C_FP32_DEPTH)}
    gc.collect()
    torch.cuda.empty_cache()

    ref_leaves = None
    if rank == 0:
        ref = new_params(cfg)
        zero_start = [bool((t == 0).all()) for t in tree_leaves(ref)]
        ref, ref_hist = TL.train_sft(ref, cfg, sft_cfg, loop, samples, processor, device="cuda:0",
                                     image_loader=loader, max_steps=PAR_MICRO)
        res["sft_ref_losses"] = [r["loss"] for r in ref_hist]
        res["sft_ref_grad_norms"] = [r["grad_norm"] for r in ref_hist]
        ref_leaves = [t.detach().cpu() for t in tree_leaves(ref)]
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    heads, restore = head_shadows()
    zero_counts()
    shards, hist = TL.train_sft(new_params(cfg), cfg, sft_cfg, loop, samples, processor, mesh=mesh, device="cuda:0",
                                image_loader=loader, max_steps=PAR_MICRO)
    launches, variants, traffic, peak = read_counts()
    restore()
    with torch.device("meta"):
        spec_tree = param_shardings(init_vlm_params(cfg, generator=torch.Generator(), device="meta"), mesh)
    specs = spec_leaves(shards, spec_tree)
    whole = [t for t, s in zip(tree_leaves(shards), specs) if not is_sharded(s, mesh)]
    prints = gather_objects(fingerprints(whole), mesh.world_group())
    res["sft"] = {"losses": [r["loss"] for r in hist], "grad_norms": [r["grad_norm"] for r in hist],
                  "step_s": [r["step_s"] for r in hist], "launches": launches, "variants": variants,
                  "traffic": traffic, "peak_gib": peak, "replicated_leaves": len(whole),
                  "split_leaves": len(specs) - len(whole), "replicas_equal": prints[0] == prints[1],
                  "history_equal": gather_objects(hist, mesh.world_group())[0] == hist,
                  "heads": {f"{k}@{h}": n for (k, h), n in heads.items()}}
    full = gather_params(shards, spec_tree, mesh, root=0)
    if rank == 0:
        # a leaf that starts at 0 (every bias) holds only AdamW's steps after the second update, each element about
        # +-lr by the sign of a running mean that bf16 sums flip where it is near 0: held apart, printed
        same, worst, worst0 = 0, 0.0, 0.0
        for a, b, z in zip(tree_leaves(full), ref_leaves, zero_start):
            b = b.to(a.device)
            same += int(torch.equal(a, b))
            rel = ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item()
            worst0, worst = (max(worst0, rel), worst) if z else (worst0, max(worst, rel))
        res["sft"].update(leaves=len(ref_leaves), leaves_bit_equal=same, worst_leaf_rel=worst,
                          zero_start_leaves=sum(zero_start), worst_zero_start_rel=worst0)
    del shards, full, ref_leaves
    gc.collect()
    torch.cuda.empty_cache()

    cfg, processor, tiles, prompt_fn, rewards, names, cut, uncut, _ = grpo_setup()
    cfg = cut_depth(cfg, layers, blocks)
    lora = TG.GRPOConfig(num_generations=PAR_FSDP_GENERATIONS, max_completion_length=GRPO_NEW_1,
                         stage2_max_completion_length=GRPO_NEW_2, rollout_temperature=0.7, learning_rate=1e-7,
                         beta=0.04, epsilon_low=0.2, epsilon_high=0.2, reuse_cache=True, use_lora=True, lora_r=8,
                         lora_alpha=16.0)
    trainer = TG.GRPOTrainer(new_params(cfg), cfg, lora, processor, rewards, reward_names=names,
                             image_loader=lambda s: tiles[s.image_name], prompt_fn=prompt_fn, device="cuda",
                             time_stages=True, mesh=mesh)
    heads, restore = head_shadows()
    zero_counts()
    t0 = time.perf_counter()
    m = trainer.step([cut], seed=3)
    wall = time.perf_counter() - t0
    launches, variants, traffic, peak = read_counts()
    restore()
    held = [t for t, s in zip(tree_leaves(trainer.params), spec_leaves(trainer.params, trainer.specs))
            if not is_sharded(s, mesh)]
    prints = gather_objects(fingerprints(held), mesh.world_group())
    res["grpo"] = {"mesh": mesh.shape, "metrics": m, "s": wall, "stages": dict(trainer.stage_seconds),
                   "launches": launches, "variants": variants, "traffic": traffic, "peak_gib": peak,
                   "rows": int(trainer._buffered.input_ids.shape[0]), "leaves_equal": prints[0] == prints[1],
                   "heads": {f"{k}@{h}": n for (k, h), n in heads.items()}}
    del trainer
    with open(os.path.join(out_dir, f"c_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def split_distances(rank, mesh, cfg, dtype, steps, out_dir, processor, samples, loader):
    """The tensor split against one rank at `cfg` in `dtype`: `steps` SFT micro-steps on
    rank 0 alone, then the same over `mesh`. On rank 0, for each leaf (its path in
    "paths"), max |mesh - one rank| / max |one rank| of the first micro-step's gradient
    ("grads"), and of the change from the starting value after the last micro-step
    ("changes_max") with its L2 form, |mesh - one rank|_2 / |one rank|_2 ("changes"; both
    0 before the first update moves a leaf); None on the other ranks. AdamW's step is
    ill-conditioned where a leaf's gradients are near 0 in every update, so the largest
    single difference in a change can reach 1 % where the gradients agree to 4e-06; the L2
    form weighs each element by what it moves."""
    import torch
    import torch.distributed as dist

    from zoomearth_tpu_torch.models.params import init_vlm_params, tree_leaves
    from zoomearth_tpu_torch.parallel.mesh import map_with_path, param_shardings, spec_leaves
    from zoomearth_tpu_torch.parallel.multihost import gather_params
    from zoomearth_tpu_torch.train import sft as TS
    from zoomearth_tpu_torch.train import sft_loop as TL

    sft_cfg = TS.SFTConfig(learning_rate=1e-4, warmup_steps=1, total_steps=8, weight_decay=0.01,
                           gradient_accumulation_steps=TRAIN_ACCUM)
    loop = TL.SFTLoopConfig(output_dir=os.path.join(out_dir, "split_sft"), num_train_epochs=1, batch_size=1,
                            save_steps=100, log_steps=1, seed=42)
    with torch.device("meta"):
        meta = init_vlm_params(cfg, generator=torch.Generator(), device="meta")
    specs = spec_leaves(meta, param_shardings(meta, mesh))

    def params():
        return init_vlm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda", dtype=dtype)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

    one, got = {}, {}
    if rank == 0:
        p = params()
        one["start"] = [t.float().cpu() for t in tree_leaves(p)]

        def keep_one(step, g):
            if step == 1:
                one["grads"] = [x.float().cpu() for x in g]

        p, _ = TL.train_sft(p, cfg, sft_cfg, loop, samples, processor, device="cuda:0", image_loader=loader,
                            max_steps=steps, on_grads=keep_one)
        one["changes"] = [t.float().cpu() - s for t, s in zip(tree_leaves(p), one["start"])]
        del p
        torch.cuda.empty_cache()
    dist.barrier()

    def keep(step, g):
        if step == 1:
            full = gather_params(list(g), specs, mesh, root=0, device="cpu")
            if rank == 0:
                got["grads"] = [rel(a.float().cpu(), b) for a, b in zip(full, one["grads"])]

    shards, _ = TL.train_sft(params(), cfg, sft_cfg, loop, samples, processor, mesh=mesh, device="cuda:0",
                             image_loader=loader, max_steps=steps, on_grads=keep)
    full = gather_params(tree_leaves(shards), specs, mesh, root=0, device="cpu")
    del shards
    torch.cuda.empty_cache()
    if rank != 0:
        return None
    changes = [(a.float().cpu() - s, c) for a, s, c in zip(full, one["start"], one["changes"])]
    got["changes"] = [rel_l2(a, c) for a, c in changes]
    got["changes_max"] = [rel(a, c) for a, c in changes]
    got["paths"] = spec_leaves(meta, map_with_path(lambda q, _: q, meta))
    return got


def tensor_grads_rank(rank, world, addr, out, layers, blocks):
    """`--tensor-grads`: split_distances over (1, 1, 2) at the 3B widths and the given
    depth for one micro-step, in fp32 and in bf16; rank 0 writes them to `out`."""
    import torch

    parallel_setup(rank, world, addr, "gloo")
    from zoomearth_tpu_torch.parallel.mesh import make_mesh

    cfg, processor, samples, loader, _ = training_setup()
    cfg = cut_depth(cfg, layers, blocks)
    got = {name: split_distances(rank, make_mesh(1, 1, 2), cfg, getattr(torch, name), 1, os.path.dirname(out),
                                 processor, samples, loader) for name in ("float32", "bfloat16")}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(got, f)


def run_tensor_grads(card, depths):
    """`--tensor-grads=L,B ...`: tensor_grads_rank at each depth, the gradient distances
    printed (worst with its leaf, median, leaves over 2^-7)."""
    import numpy as np

    from zoomearth_tpu_torch.parallel.launch import run_ranks

    for layers, blocks in depths:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_grads_") as tmp:
            out = os.path.join(tmp, "grads.json")
            run_ranks(f"{os.path.join(REPO, 'chip_smoke.py')}:tensor_grads_rank", 2,
                      {"out": out, "layers": layers, "blocks": blocks}, timeout_s=PAR_TIMEOUT_C, cwd=REPO)
            got = json.load(open(out))
        for name, d in got.items():
            v = np.asarray(d["grads"])
            log(f"  {layers} layers / {blocks} ViT blocks, {name}, (1, 1, 2) against one rank: worst {v.max():.3e} "
                f"({d['paths'][int(v.argmax())]}), median {np.median(v):.3e}, leaves over 2^-7 "
                f"{int((v > 2 ** -7).sum())} of {len(v)} | {card}")


def run_parallel(card):
    """[parallel] (the module docstring, phase 11): the groups of ranks, their
    lines and checks. Returns {kernel name: {"launches_parallel": n}}."""
    from zoomearth_tpu_torch.parallel.launch import run_ranks

    import gc

    import torch

    from zoomearth_tpu_torch.scripts.timing import release_flush_buffer

    tol = 2.0 ** -7
    # the ranks share the card with this process: [kernels]' L2 flush buffer (128 MiB) and cuBLAS's workspaces pinned
    # a 6.4 GiB segment of its cache here, which empty_cache cannot return while they live
    release_flush_buffer()
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"  before the ranks start: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; the card {(total - free) / 2**30:.2f} of "
        f"{total / 2**30:.2f} GiB in use | {card}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        log(f"  (a) nccl, one rank on cuda:0, mesh (1, 1, 1), Qwen2.5-VL-3B at full depth: train_sft(mesh=) for "
            f"{PAR_MICRO} micro-steps against the unsharded train_sft, then one GRPOTrainer(mesh=) LoRA step")
        t0 = time.time()
        run_ranks(f"{os.path.join(REPO, 'chip_smoke.py')}:parallel_nccl", 1, {"out": os.path.join(tmp, "a.json")},
                  timeout_s=PAR_TIMEOUT_A, cwd=REPO)
        a = json.load(open(os.path.join(tmp, "a.json")))
        log(f"  (a) took {time.time() - t0:.1f} s of command (the rank's start, two 3B trees, 2 x {PAR_MICRO} "
            f"micro-steps, the GRPO step)")
        sa, ga = a["sft"], a["grpo"]
        bit = sa["losses"] == sa["ref_losses"] and sa["grad_norms"] == sa["ref_grad_norms"]
        log(f"  (a) SFT on the mesh: losses {sa['losses']}, grad norms {sa['grad_norms']}; unsharded: "
            f"{sa['ref_losses']}, {sa['ref_grad_norms']} ({'bit for bit' if bit else 'NOT bit for bit'}); after "
            f"{PAR_MICRO // TRAIN_ACCUM} updates {sa['leaves_bit_equal']} of {sa['leaves']} leaves bit for bit, "
            f"worst leaf max |diff| / max |value| {sa['worst_leaf_rel']:.3e} (tol 2^-7)")
        tr = EARLIER.get("training", {})
        log(f"  (a) SFT seconds per micro-step on the mesh {sum(sa['step_s']) / PAR_MICRO:.3f}, unsharded in the same "
            f"rank {sum(sa['ref_step_s']) / PAR_MICRO:.3f} (run first: it pays the warm-up), [training] {tr.get('s_per_micro_step', float('nan')):.3f}; "
            f"peak {sa['peak_gib']:.2f} GiB ([training] {tr.get('peak_gib', float('nan')):.2f}); collective bytes "
            f"{sa['traffic']} | {card}")
        log(f"  (a) SFT launches {sa['launches']}; by variant {sa['variants']}")
        gr = EARLIER.get(GRPO_LORA_LABEL, {})
        log(f"  (a) GRPO LoRA cut step on the mesh {ga['s']:.3f} s ([grpo]'s {gr.get('s', float('nan')):.3f}), by "
            f"stage { {k: round(v, 3) for k, v in ga['stages'].items()} }, {ga['rows']} rows, peak "
            f"{ga['peak_gib']:.2f} GiB ([grpo]'s {gr.get('peak_gib', float('nan')):.2f}); metrics {ga['metrics']} | "
            f"{card}")
        log(f"  (a) GRPO launches {ga['launches']}; by variant {ga['variants']}")
        L, V = 36, 32
        assert sa["depth"] == [L, V], sa["depth"]
        assert sa["worst_leaf_rel"] <= tol, sa["worst_leaf_rel"]
        assert all(abs(x - y) <= tol * abs(y) for x, y in zip(sa["losses"] + sa["grad_norms"],
                                                              sa["ref_losses"] + sa["ref_grad_norms"])), sa
        assert sa["launches"]["flash_segment_attention"] == sa["launches"]["flash_segment_attention_bwd"] == V * PAR_MICRO
        assert sa["launches"]["flash_causal_attention"] == sa["launches"]["flash_causal_attention_bwd"] == L * PAR_MICRO
        assert all(v["fma"] == 0 for v in sa["variants"].values()) and all(
            v["fma"] == 0 for v in ga["variants"].values()), (sa["variants"], ga["variants"])
        assert ga["launches"]["flash_causal_attention_bwd"] == L and ga["launches"]["flash_decode_attention"] > 0
        assert all(isinstance(v, float) and v == v for v in ga["metrics"].values()), ga["metrics"]

        log(f"  (b) gloo, two ranks sharing cuda:0 (host copies carry every collective: its times are not an NCCL "
            f"figure), Qwen2.5-VL-3B widths at {PAR_LAYERS} decoder layers and {PAR_BLOCKS} ViT blocks (the phase's "
            f"one reduction): {PAR_MICRO} SFT micro-steps over (1, 2, 1) against the unsharded run, one LoRA GRPO "
            f"step over (1, 2, 1) (G = {PAR_FSDP_GENERATIONS}), then over (2, 1, 1) one LoRA GRPO step, the engine tick and the pair wave")
        t1 = time.time()
        run_ranks(f"{os.path.join(REPO, 'chip_smoke.py')}:parallel_gloo", 2,
                  {"out_dir": tmp, "layers": PAR_LAYERS, "blocks": PAR_BLOCKS}, timeout_s=PAR_TIMEOUT_B, cwd=REPO)
        b = [json.load(open(os.path.join(tmp, f"b_rank{r}.json"))) for r in range(2)]
        log(f"  (b) took {time.time() - t1:.1f} s of command")
        for r in b:
            s, f, g, v = r["sft"], r["grpo_fsdp"], r["grpo"], r["serve"]
            log(f"  (b) rank {r['rank']} ({r['backend']}, {r['device']}): SFT losses {s['losses']}, grad norms "
                f"{s['grad_norms']}, {sum(s['step_s']) / PAR_MICRO:.3f} s a micro-step, peak {s['peak_gib']:.2f} GiB, "
                f"collective bytes {s['traffic']}, {s['split_leaves']} leaves split and {s['replicated_leaves']} "
                f"whole | {card}")
            for name, x in (("GRPO step over (1, 2, 1)", f), ("GRPO step over (2, 1, 1)", g)):
                log(f"  (b) rank {r['rank']} {name}: {x['s']:.3f} s (by stage "
                    f"{ {k: round(y, 3) for k, y in x['stages'].items()} }), peak {x['peak_gib']:.2f} GiB, collective "
                    f"bytes {x['traffic']} | {card}")
            log(f"  (b) rank {r['rank']} engine and wave peak {v['peak_gib']:.2f} GiB | {card}")
            log(f"  (b) rank {r['rank']} launches: SFT {s['launches']} (variants {s['variants']}); GRPO over (1, 2, 1) "
                f"{f['launches']}; GRPO over (2, 1, 1) {g['launches']} (variants {g['variants']}); engine tick and "
                f"pair wave {v['launches']}")
        s0 = b[0]["sft"]
        log(f"  (b) SFT against the single-process unsharded run at the same depth: losses {s0['losses']} vs "
            f"{b[0]['sft_ref_losses']}, grad norms {s0['grad_norms']} vs {b[0]['sft_ref_grad_norms']}; after "
            f"{PAR_MICRO // TRAIN_ACCUM} updates {s0['leaves_bit_equal']} of {s0['leaves']} gathered leaves bit for "
            f"bit, worst leaf max |diff| / max |value| {s0['worst_leaf_rel']:.3e} (tol 2^-7)")
        log(f"  (b) GRPO over (1, 2, 1): metrics {b[0]['grpo_fsdp']['metrics']}, rows {b[0]['grpo_fsdp']['rows']}, "
            f"replicated leaves equal across ranks {b[0]['grpo_fsdp']['leaves_equal']}")
        log(f"  (b) replicas equal in bits: {[r['sft']['replicas_equal'] for r in b]}, "
            f"histories equal: {[r['sft']['history_equal'] for r in b]}; GRPO metrics {b[0]['grpo']['metrics']}, "
            f"rows {b[0]['grpo']['rows']}, leaves equal across ranks {b[0]['grpo']['leaves_equal']}; engine tokens "
            f"{b[0]['serve']['engine_tokens']}, stats {b[0]['serve']['stats']}, wave {b[0]['serve']['wave_lengths']}, "
            f"equal across ranks {b[0]['serve']['tokens_equal']}")
        for r in b:
            s, f, g, v = r["sft"], r["grpo_fsdp"], r["grpo"], r["serve"]
            assert s["replicas_equal"] and s["history_equal"] and f["leaves_equal"] and g["leaves_equal"] and \
                v["tokens_equal"], r
            assert s["launches"]["flash_segment_attention"] == s["launches"]["flash_segment_attention_bwd"] == \
                PAR_BLOCKS * PAR_MICRO, s["launches"]
            assert s["launches"]["flash_causal_attention"] == s["launches"]["flash_causal_attention_bwd"] == \
                PAR_LAYERS * PAR_MICRO, s["launches"]
            assert all(x["fma"] == 0 for x in list(s["variants"].values()) + list(f["variants"].values())
                       + list(g["variants"].values()))
            for x in (f, g):
                assert x["launches"]["flash_causal_attention_bwd"] == PAR_LAYERS and \
                    x["launches"]["flash_decode_attention"], x["launches"]
            assert v["launches"]["flash_decode_attention"] > 0 and v["launches"]["flash_causal_attention"] > 0
        for k in ("grpo_fsdp", "grpo"):
            assert b[0][k]["metrics"] == b[1][k]["metrics"], k
            assert all(isinstance(v, float) and v == v for v in b[0][k]["metrics"].values()), b[0][k]["metrics"]
        assert b[0]["sft"]["losses"] == b[1]["sft"]["losses"]
        assert s0["worst_leaf_rel"] <= tol, s0["worst_leaf_rel"]
        assert all(abs(x - y) <= tol * abs(y) for x, y in zip(s0["losses"] + s0["grad_norms"],
                                                              b[0]["sft_ref_losses"] + b[0]["sft_ref_grad_norms"])), s0
        c = run_tensor_part(card, tmp, tol)
        d = run_tensor4_part(card, tmp, tol)
    names = list(parallel_counters())
    total = {n: a["sft"]["launches"][n] + a["grpo"]["launches"][n]
             + sum(r[k]["launches"][n] for r in b for k in ("sft", "grpo_fsdp", "grpo", "serve"))
             + sum(r[k]["launches"][n] for r in c for k in ("sft", "grpo"))
             + sum(r["sft"]["launches"][n] for r in d)
             for n in names}
    return {n: {"launches_parallel": total[n]} for n in names}


def run_tensor_part(card, tmp, tol):
    """[parallel] part (c): the group of two tensor ranks, its lines and checks."""
    from zoomearth_tpu_torch.parallel.launch import run_ranks

    L, V, M = PAR_C_LAYERS, PAR_C_BLOCKS, PAR_MICRO
    log(f"  (c) gloo, two ranks sharing cuda:0 on the tensor axis, mesh (1, 1, 2), Qwen2.5-VL-3B widths at {L} decoder "
        f"layers and {V} ViT blocks: {M} SFT micro-steps (each rank its 8 heads and half the MLP widths) against the "
        f"unsharded run, then one LoRA GRPO cut step (G = {PAR_FSDP_GENERATIONS}; the decoder's blocks whole)")
    t0 = time.time()
    run_ranks(f"{os.path.join(REPO, 'chip_smoke.py')}:parallel_tensor", 2,
              {"out_dir": tmp, "layers": L, "blocks": V}, timeout_s=PAR_TIMEOUT_C, cwd=REPO)
    c = [json.load(open(os.path.join(tmp, f"c_rank{r}.json"))) for r in range(2)]
    log(f"  (c) took {time.time() - t0:.1f} s of command")
    for r in c:
        s, g = r["sft"], r["grpo"]
        log(f"  (c) rank {r['rank']} ({r['backend']}, {r['device']}): SFT losses {s['losses']}, grad norms "
            f"{s['grad_norms']}, {sum(s['step_s']) / M:.3f} s a micro-step, peak {s['peak_gib']:.2f} GiB, collective "
            f"bytes {s['traffic']}, {s['split_leaves']} leaves split and {s['replicated_leaves']} whole | {card}")
        log(f"  (c) rank {r['rank']} GRPO LoRA step over (1, 1, 2): {g['s']:.3f} s (by stage "
            f"{ {k: round(y, 3) for k, y in g['stages'].items()} }), {g['rows']} rows, peak {g['peak_gib']:.2f} GiB, "
            f"collective bytes {g['traffic']} | {card}")
        log(f"  (c) rank {r['rank']} launches: SFT {s['launches']} (variants {s['variants']}), by kernel@heads "
            f"{s['heads']}; GRPO {g['launches']} (variants {g['variants']}), by kernel@heads {g['heads']}")
    s0, f32 = c[0]["sft"], c[0]["fp32"]
    log(f"  (c) fp32 at {f32['depth'][0]} layers / {f32['depth'][1]} ViT blocks, full width, over (1, 1, 2) against "
        f"one rank, {f32['leaves']} leaves gathered: the first micro-step's gradients, worst max |diff| / max |value| "
        f"{f32['worst_grad_rel']:.3e} ({f32['worst_grad_leaf']}; tol {PAR_C_FP32_TOL:g}); each leaf's change after "
        f"{M // TRAIN_ACCUM} updates, biases included, worst |diff|_2 / |change|_2 {f32['worst_change_rel']:.3e} "
        f"({f32['worst_change_leaf']}; tol 2^-7), worst max |diff| / max |change| {f32['worst_change_max']:.3e} "
        f"({f32['worst_change_max_leaf']}; AdamW's step is ill-conditioned where a gradient is near 0 in both updates)")
    log(f"  (c) SFT against the single-process unsharded run at the same depth: losses {s0['losses']} vs "
        f"{c[0]['sft_ref_losses']}, grad norms {s0['grad_norms']} vs {c[0]['sft_ref_grad_norms']}; after "
        f"{M // TRAIN_ACCUM} updates {s0['leaves_bit_equal']} of {s0['leaves']} gathered leaves bit for bit, worst "
        f"leaf max |diff| / max |value| {s0['worst_leaf_rel']:.3e} (tol 2^-7; no power at lr 1e-4: one update moves "
        f"an element by about lr, 1e-3 of a leaf's largest value) over the {s0['leaves'] - s0['zero_start_leaves']} "
        f"leaves that start nonzero, {s0['worst_zero_start_rel']:.3e} over the {s0['zero_start_leaves']} that start at "
        f"0 (the biases: their values are AdamW's +-lr steps, whose signs bf16 sums flip where a running mean is near "
        f"0; the fp32 changes above hold them); replicas equal in bits "
        f"{[r['sft']['replicas_equal'] for r in c]}, histories equal {[r['sft']['history_equal'] for r in c]}; GRPO "
        f"metrics {c[0]['grpo']['metrics']}, replicated leaves equal across ranks "
        f"{[r['grpo']['leaves_equal'] for r in c]}")
    split_heads = {"flash_segment_attention@8": V * M, "flash_segment_attention_bwd@8": V * M,
                   "flash_causal_attention@8/1": L * M, "flash_causal_attention_bwd@8/1": L * M}
    for r in c:
        s, g = r["sft"], r["grpo"]
        assert s["replicas_equal"] and s["history_equal"] and g["leaves_equal"], r
        assert s["launches"]["flash_segment_attention"] == s["launches"]["flash_segment_attention_bwd"] == V * M, \
            s["launches"]
        assert s["launches"]["flash_causal_attention"] == s["launches"]["flash_causal_attention_bwd"] == L * M, \
            s["launches"]
        assert s["heads"] == split_heads, s["heads"]
        assert all(x["fma"] == 0 for x in list(s["variants"].values()) + list(g["variants"].values())), r
        # the policy's backward: the ViT on its 8 local heads, the LoRA decoder whole at 16 / 2
        assert g["heads"].get("flash_segment_attention_bwd@8") == V and \
            g["heads"].get("flash_causal_attention_bwd@16/2") == L, g["heads"]
        assert not [k for k in g["heads"] if "_bwd@" in k and k not in ("flash_segment_attention_bwd@8",
                                                                       "flash_causal_attention_bwd@16/2")], g["heads"]
        assert g["launches"]["flash_causal_attention_bwd"] == L and g["launches"]["flash_decode_attention"], g
        assert s["traffic"].get("all_reduce", 0) > 0 and g["traffic"].get("all_gather", 0) > 0, r
    assert c[0]["grpo"]["metrics"] == c[1]["grpo"]["metrics"]
    assert all(isinstance(v, float) and v == v for v in c[0]["grpo"]["metrics"].values()), c[0]["grpo"]["metrics"]
    assert c[0]["sft"]["losses"] == c[1]["sft"]["losses"]
    assert f32["worst_grad_rel"] <= PAR_C_FP32_TOL and f32["worst_change_rel"] <= tol, f32
    assert s0["worst_leaf_rel"] <= tol, s0["worst_leaf_rel"]
    assert all(abs(x - y) <= tol * abs(y) for x, y in zip(s0["losses"] + s0["grad_norms"],
                                                          c[0]["sft_ref_losses"] + c[0]["sft_ref_grad_norms"])), s0
    return c


def parallel_tensor4(rank, world, addr, out_dir, layers, blocks):
    """[parallel] part (d), four ranks on cuda:0 over gloo on a (1, 1, 4) mesh, where two
    ranks share each of the 3B decoder's 2 KV heads: the fp32 check of the split
    (split_distances at PAR_C_FP32_DEPTH), then in bf16 at `layers` decoder layers and
    `blocks` ViT blocks rank 0's single-process unsharded reference and PAR_MICRO SFT
    micro-steps over the tensor axis (each rank 4 ViT heads, 4 query heads against its
    shared KV head, a quarter of every MLP width), the dispatchers shadowed to count
    calls by heads."""
    import gc

    import torch
    import torch.distributed as dist

    parallel_setup(rank, world, addr, "gloo")
    from zoomearth_tpu_torch.models.params import init_vlm_params, tree_leaves
    from zoomearth_tpu_torch.parallel.collectives import gather_objects
    from zoomearth_tpu_torch.parallel.mesh import is_sharded, make_mesh, param_shardings, spec_leaves
    from zoomearth_tpu_torch.train import sft as TS
    from zoomearth_tpu_torch.train import sft_loop as TL

    res = {"rank": rank, "backend": "gloo", "device": f"cuda:{torch.cuda.current_device()}"}
    cfg, processor, samples, loader, _ = training_setup()
    mesh = make_mesh(1, 1, 4)
    d = split_distances(rank, mesh, cut_depth(cfg, *PAR_C_FP32_DEPTH), torch.float32, PAR_MICRO, out_dir, processor,
                        samples, loader)
    if rank == 0:
        res["fp32"] = {"leaves": len(d["grads"]), "worst_grad_rel": max(d["grads"]),
                       "worst_grad_leaf": d["paths"][d["grads"].index(max(d["grads"]))],
                       "worst_change_rel": max(d["changes"]),
                       "worst_change_leaf": d["paths"][d["changes"].index(max(d["changes"]))],
                       "depth": list(PAR_C_FP32_DEPTH)}
    gc.collect()
    torch.cuda.empty_cache()

    cfg = cut_depth(cfg, layers, blocks)

    def new_params():
        return init_vlm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda", dtype=torch.bfloat16)

    sft_cfg = TS.SFTConfig(learning_rate=1e-4, warmup_steps=1, total_steps=8, weight_decay=0.01,
                           gradient_accumulation_steps=TRAIN_ACCUM)
    loop = TL.SFTLoopConfig(output_dir=os.path.join(out_dir, "d_sft"), num_train_epochs=1, batch_size=1,
                            save_steps=100, log_steps=1, seed=42)
    if rank == 0:
        ref, ref_hist = TL.train_sft(new_params(), cfg, sft_cfg, loop, samples, processor, device="cuda:0",
                                     image_loader=loader, max_steps=PAR_MICRO)
        res["sft_ref_losses"] = [r["loss"] for r in ref_hist]
        res["sft_ref_grad_norms"] = [r["grad_norm"] for r in ref_hist]
        del ref  # the trained tree: the four ranks' trees need its room on the shared card
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    heads, restore = head_shadows()
    zero_counts()
    shards, hist = TL.train_sft(new_params(), cfg, sft_cfg, loop, samples, processor, mesh=mesh, device="cuda:0",
                                image_loader=loader, max_steps=PAR_MICRO)
    launches, variants, traffic, peak = read_counts()
    restore()
    with torch.device("meta"):
        spec_tree = param_shardings(init_vlm_params(cfg, generator=torch.Generator(), device="meta"), mesh)
    specs = spec_leaves(shards, spec_tree)
    whole = [t for t, s in zip(tree_leaves(shards), specs) if not is_sharded(s, mesh)]
    prints = gather_objects(fingerprints(whole), mesh.world_group())
    res["sft"] = {"losses": [r["loss"] for r in hist], "grad_norms": [r["grad_norm"] for r in hist],
                  "step_s": [r["step_s"] for r in hist], "launches": launches, "variants": variants,
                  "traffic": traffic, "peak_gib": peak, "replicated_leaves": len(whole),
                  "split_leaves": len(specs) - len(whole), "replicas_equal": all(p == prints[0] for p in prints),
                  "history_equal": all(h == hist for h in gather_objects(hist, mesh.world_group())),
                  "heads": {f"{k}@{h}": n for (k, h), n in heads.items()}, "depth": [layers, blocks]}
    del shards
    with open(os.path.join(out_dir, f"d_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def run_tensor4_part(card, tmp, tol):
    """[parallel] part (d): the group of four tensor ranks, its lines and checks."""
    from zoomearth_tpu_torch.parallel.launch import run_ranks

    L, V, M = PAR_C_LAYERS, PAR_C_BLOCKS, PAR_MICRO
    log(f"  (d) gloo, four ranks sharing cuda:0 on the tensor axis, mesh (1, 1, 4): two ranks share each of the 2 KV "
        f"heads. fp32 at {PAR_C_FP32_DEPTH[0]} layers / {PAR_C_FP32_DEPTH[1]} ViT blocks against one rank, then "
        f"Qwen2.5-VL-3B at full depth, {L} decoder layers and {V} ViT blocks: {M} bf16 SFT "
        f"micro-steps (each rank 4 ViT heads, 4 / 1 decoder heads, a quarter of every MLP width) against the "
        f"unsharded run; no GRPO step here (the CPU tests hold GRPO on (1, 1, 4) against the JAX trainer)")
    t0 = time.time()
    # four full-depth ranks peak at ~16.3 GiB allocated each; without expandable segments the caching allocator held
    # ~1.4 GiB more a rank, reserved and unused, and the four ran out of the card's memory
    run_ranks(f"{os.path.join(REPO, 'chip_smoke.py')}:parallel_tensor4", 4,
              {"out_dir": tmp, "layers": L, "blocks": V}, timeout_s=PAR_TIMEOUT_D, cwd=REPO,
              env=dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    d = [json.load(open(os.path.join(tmp, f"d_rank{r}.json"))) for r in range(4)]
    log(f"  (d) took {time.time() - t0:.1f} s of command")
    for r in d:
        s = r["sft"]
        per_step = {k: v / M for k, v in s["traffic"].items()}
        log(f"  (d) rank {r['rank']} ({r['backend']}, {r['device']}): SFT losses {s['losses']}, grad norms "
            f"{s['grad_norms']}, {sum(s['step_s']) / M:.3f} s a micro-step, peak {s['peak_gib']:.2f} GiB, collective "
            f"bytes a micro-step {per_step} (kv_*: the KV-replica groups'), {s['split_leaves']} leaves split and "
            f"{s['replicated_leaves']} whole | {card}")
        log(f"  (d) rank {r['rank']} launches: SFT {s['launches']} (variants {s['variants']}), by kernel@heads "
            f"{s['heads']}")
    s0, f32 = d[0]["sft"], d[0]["fp32"]
    log(f"  (d) fp32 at {f32['depth'][0]} layers / {f32['depth'][1]} ViT blocks over (1, 1, 4) against one rank, "
        f"{f32['leaves']} leaves gathered: the first micro-step's gradients, worst max |diff| / max |value| "
        f"{f32['worst_grad_rel']:.3e} ({f32['worst_grad_leaf']}; tol {PAR_C_FP32_TOL:g}); each leaf's change after "
        f"{M // TRAIN_ACCUM} updates, worst |diff|_2 / |change|_2 {f32['worst_change_rel']:.3e} "
        f"({f32['worst_change_leaf']}; tol 2^-7)")
    log(f"  (d) bf16 SFT against the single-process unsharded run at the same depth: losses {s0['losses']} vs "
        f"{d[0]['sft_ref_losses']}, grad norms {s0['grad_norms']} vs {d[0]['sft_ref_grad_norms']}; replicas equal in "
        f"bits {[r['sft']['replicas_equal'] for r in d]}, histories equal {[r['sft']['history_equal'] for r in d]}")
    split_heads = {"flash_segment_attention@4": V * M, "flash_segment_attention_bwd@4": V * M,
                   "flash_causal_attention@4/1": L * M, "flash_causal_attention_bwd@4/1": L * M}
    for r in d:
        s = r["sft"]
        assert s["replicas_equal"] and s["history_equal"], r
        assert s["heads"] == split_heads, s["heads"]
        assert s["launches"]["flash_segment_attention"] == s["launches"]["flash_segment_attention_bwd"] == V * M
        assert s["launches"]["flash_causal_attention"] == s["launches"]["flash_causal_attention_bwd"] == L * M
        assert all(x["fma"] == 0 for x in s["variants"].values()), s["variants"]
        assert s["traffic"].get("kv_all_gather", 0) > 0 and s["traffic"].get("kv_all_reduce", 0) > 0, s["traffic"]
        assert s["losses"] == s0["losses"]
    assert f32["worst_grad_rel"] <= PAR_C_FP32_TOL and f32["worst_change_rel"] <= tol, f32
    assert all(abs(x - y) <= tol * abs(y) for x, y in zip(s0["losses"] + s0["grad_norms"],
                                                          d[0]["sft_ref_losses"] + d[0]["sft_ref_grad_norms"])), s0
    return d


def profile_training(card):
    """`--profile-sft`: where one warm SFT micro-step's time goes, by kernel. The
    training phase's model, samples and processor; gradient accumulation over 8
    micro-steps, so that no optimizer update falls in the window; two micro-steps to
    warm up, then one cut sample's micro-step on the host clock (synchronized) and once
    more under torch.profiler, with the device time of the kernels by group and of every
    kernel that takes at least 1 % of the total."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zoomearth_tpu_torch.train import sft as TS
    from zoomearth_tpu_torch.train import sft_loop as TL

    cfg, processor, samples, loader, new_params = training_setup()
    params = new_params()
    TL.make_trainable(params)
    opt = TS.make_optimizer(params, TS.SFTConfig(learning_rate=1e-4, warmup_steps=1, total_steps=8,
                                                 gradient_accumulation_steps=8))
    cut = next(smp for smp in samples if smp.cut)
    batch = TS.batch_to_device(TL.collate_sft([cut], processor, image_loader=loader), "cuda")

    def step():
        torch.cuda.synchronize()
        t0 = time.time()
        TS.train_step(params, opt, batch, cfg=cfg)
        torch.cuda.synchronize()
        return time.time() - t0

    def measured():
        secs = step()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = step()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        total = sum(ms for _, ms, _ in rows)
        log(f"  one micro-step ({batch['input_ids'].shape[1]} tokens, {batch['pixel_values'].shape[0]} "
            f"patches) {secs:.3f} s on the host clock, synchronized; under the profiler wall {wall:.3f} s, device "
            f"kernel time {total:.1f} ms | {card}")
        if total <= 0:
            raise AssertionError("the profiler recorded no device time")
        groups = {"GEMM kernels (nvjet, cutlass, gemm, gemv)": ("nvjet", "cutlass", "gemm", "gemv"),
                  "K1-bwd zt::flash_segment_bwd": ("zt::flash_segment_bwd",),
                  "K2-bwd zt::flash_causal_bwd": ("zt::flash_causal_bwd",),
                  "K1 zt::flash_segment (forward)": ("zt::flash_segment",),
                  "K2 zt::flash_causal (forward)": ("zt::flash_causal",)}
        taken = set()
        for name, keys in groups.items():
            hit = [r for r in rows if r[0] not in taken and any(k in r[0] for k in keys)]
            taken.update(r[0] for r in hit)
            ms, n = sum(r[1] for r in hit), sum(r[2] for r in hit)
            log(f"    {ms:9.2f} ms {100 * ms / total:5.1f} % {n:6d} calls  {name}")
        rest = [r for r in rows if r[0] not in taken]
        log(f"    {sum(r[1] for r in rest):9.2f} ms {100 * sum(r[1] for r in rest) / total:5.1f} % "
            f"{sum(r[2] for r in rest):6d} calls  every other kernel (elementwise, copies, reductions, indexing)")
        log("    kernels with at least 1 % of the device time, and every kernel of this repository:")
        for key, ms, count in sorted(rows, key=lambda r: -r[1]):
            if ms >= 0.01 * total or "zt::" in key:
                log(f"      {ms:9.2f} ms {100 * ms / total:5.1f} % {count:6d} calls  {key[:100]}")

    step()
    step()
    measured()


def check_tiny_parity():
    """Tiny config: in fp32 every kernel on the card against the CPU plain path, then
    in bf16 the card's kernels against the plain versions on the card."""
    import dataclasses

    import numpy as np
    import torch

    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models import decoder, vit
    from zoomearth_tpu_torch.models.params import init_vlm_params, map_tree
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator, prepare_batch

    cfg = VLMConfig.tiny()
    rng = np.random.default_rng(0)
    tok = cfg.tokens
    seqs, imgs = [], []
    for i, grid in enumerate([(1, 4, 4), (1, 8, 8), (1, 6, 10)]):
        n = grid[1] * grid[2] // 4
        seqs.append([tok.im_start, 40 + i, tok.vision_start] + [tok.image_pad] * n
                    + [tok.vision_end] + [50 + j for j in range(3 + 4 * i)])
        imgs.append([(rng.standard_normal((grid[1] * grid[2], cfg.vision.patch_dim)).astype(np.float32), grid)])
    batch = prepare_batch(cfg, seqs, imgs, length_buckets=(64,), patch_buckets=(256,))
    params = init_vlm_params(cfg, torch.Generator().manual_seed(0))
    gen = GenerationConfig(max_new_tokens=16, temperature=0.0)
    cpu_g = Generator(params, cfg, max_cache_len=128)
    gpu_g = Generator(map_tree(lambda t: t.cuda(), params), cfg, max_cache_len=128)
    lc = cpu_g.run_prefill(batch, max_new=16)[0]
    lg = gpu_g.run_prefill(batch, max_new=16)[0].cpu()
    err = (lc - lg).abs().max().item()
    toks_cpu, toks_gpu = cpu_g.generate(batch, gen), gpu_g.generate(batch, gen)
    log(f"  tiny fp32 prefill logits max_abs_err {err:.3e} (tol 1e-4); greedy tokens "
        f"{'identical' if toks_cpu == toks_gpu else 'DIFFER'} ({sum(map(len, toks_gpu))} tokens)")
    if not (err <= 1e-4 and toks_cpu == toks_gpu):
        raise AssertionError("tiny-config parity on the card failed")

    # bf16: the same weights and batch through the kernels (K2's tensor-core variant at
    # head dim 16; K1's fp32-arithmetic variant, the tiny ViT's head dim 8 being no
    # multiple of 16) and through the plain versions, both on the card
    bf_g = Generator(map_tree(lambda t: t.cuda().to(torch.bfloat16), params),
                     dataclasses.replace(cfg, dtype="bfloat16"), max_cache_len=128)
    before = dict(K2.causal_attention_cuda.variants)
    lk = bf_g.run_prefill(batch, max_new=16)[0]
    ran = {name: n - before[name] for name, n in K2.causal_attention_cuda.variants.items()}
    kernels = (vit.flash_segment_attention, decoder.flash_causal_attention)
    vit.flash_segment_attention, decoder.flash_causal_attention = (K1.flash_segment_attention_plain,
                                                                   K2.flash_causal_attention_plain)
    try:
        lp = bf_g.run_prefill(batch, max_new=16)[0]
    finally:
        vit.flash_segment_attention, decoder.flash_causal_attention = kernels
    err = max_err(lk, lp)
    # bf16 activations through two layers: one bf16 step (2^-8) of logits of size ~4, a few times over
    tol = 6e-2
    log(f"  tiny bf16 prefill logits, kernels vs plain versions on the card: max_abs_err {err:.3e} (tol {tol}; "
        f"max |logit| {lp.abs().max().item():.2f}); K2 variants that ran: {ran}")
    if not (err <= tol and ran["mma"] > 0 and ran["fma"] == 0 and bool(torch.isfinite(lk).all())):
        raise AssertionError("tiny-config bf16 parity on the card failed")


def legible_tokenizer(tokens):
    """A FakeTokenizer that reads every id that is no special token as a letter: random
    weights pick ids all over the model's vocabulary, where the byte-level tokenizer has
    no text, and a completion without text is read as no completion at all."""
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer

    class LegibleTokenizer(FakeTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            return "".join((self._id_to_special[int(i)] if not skip_special_tokens else "")
                           if int(i) in self._id_to_special else chr(97 + int(i) % 26) for i in ids)

    return LegibleTokenizer(tokens)


def synthetic_tile(seed, size=5000):
    """A 5000 px RGB tile: coarse random blocks upsampled (LRS-GRO tiles are ~5000 px)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    small = rng.integers(0, 255, (50, 50, 3), dtype=np.uint8)
    return Image.fromarray(np.kron(small, np.ones((size // 50, size // 50, 1), dtype=np.uint8)))


def slice_setup():
    """The 3B slice's model and inputs: Qwen2.5-VL-3B at full width with random bf16
    weights from seed 0, the processor, PIPE_SAMPLES LRS-GRO-shaped samples over 4
    synthetic tiles (the slice phase takes the first SAMPLES of them), greedy
    generation of NEW_TOKENS tokens per stage."""
    import types

    import torch

    from zoomearth_tpu_torch.agent import episode as EP
    from zoomearth_tpu_torch.agent import prompts as PT
    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models.params import init_vlm_params, param_count
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator
    from zoomearth_tpu_torch.tokenizer import FakeTokenizer
    from zoomearth_tpu_torch.train.data import LRSGROSample

    t0 = time.time()
    cfg = VLMConfig.qwen2_5_vl_3b()
    params = init_vlm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    log(f"  Qwen2.5-VL-3B random bf16 params: {param_count(params) / 1e9:.3f} B")
    processor = Processor(FakeTokenizer(cfg.tokens), cfg, max_pixels=512 * 512)
    # The byte-level FakeTokenizer makes the verbatim instruction ~2300 tokens (over the
    # 2048 length bucket): keep the prompt's structure with a shortened instruction.
    instruction = PT.INSTRUCTION_EVAL[:80] + "<|im_end|><|im_start|>assistant\n"
    PT.stage1_prompt = lambda q: PT.PREFIX + q + instruction
    # Random weights emit no bbox: force one so stage 2 always runs.
    EP.extract_bboxes = lambda text, scale=1.0: [[2200, 2200, 2380, 2350]]

    tiles = {f"tile{i}.png": synthetic_tile(i) for i in range(4)}
    samples = [LRSGROSample(question_id=str(i), image_name=f"tile{i % 4}.png", category="object",
                            question=f"what is near the marked area {i}?", higher_level="perception",
                            ground_truth="ship", bbox=[2200, 2200, 2380, 2350], type="object")
               for i in range(PIPE_SAMPLES)]
    return types.SimpleNamespace(
        cfg=cfg, params=params, processor=processor, tiles=tiles, samples=samples, init_s=init_s,
        generator=Generator(params, cfg, max_cache_len=4096),
        gen=GenerationConfig(max_new_tokens=NEW_TOKENS, temperature=0.0))


def run_slice(card, env):
    import torch

    from zoomearth_tpu_torch.agent import episode as EP
    from zoomearth_tpu_torch.eval.infer import run_inference
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3

    cfg, generator, processor, samples, tiles, gen = (env.cfg, env.generator, env.processor, env.samples[:SAMPLES],
                                                     env.tiles, env.gen)
    phases = {"init_params_s": env.init_s}
    kernels = (K1.segment_attention_cuda, K2.causal_attention_cuda, K3.decode_attention_cuda)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        out_path = os.path.join(out_dir, "smoke0.jsonl")
        for k in kernels:
            k.launches = 0
        for k in kernels[:2]:
            k.variants = dict.fromkeys(k.variants, 0)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        graphs0, steps0 = graph_counts(generator), generator.decode_steps["solo"]
        t0 = time.time()
        run_inference(generator, processor, samples, out_path, batch_size=BATCH, gen=gen, stage2_gen=gen,
                      image_loader=lambda s: tiles[s.image_name])
        torch.cuda.synchronize()
        phases["run_inference_s"] = time.time() - t0
        t0 = time.time()
        reuse = EP.run_episodes(generator, processor, [s.question for s in samples[:BATCH]],
                                [tiles[s.image_name] for s in samples[:BATCH]], gen=gen, reuse_cache=True)
        torch.cuda.synchronize()
        phases["run_episodes_reuse_s"] = time.time() - t0
        launches = {k.__name__: k.launches for k in kernels}
        variants = {k.__name__: dict(k.variants) for k in kernels[:2]}
        peak = torch.cuda.max_memory_allocated()
        records = [json.loads(line) for line in open(out_path)]
        graphs = graph_line(generator, graphs0)
        steps = generator.decode_steps["solo"] - steps0

    assert len(records) == SAMPLES, f"{len(records)} of {SAMPLES} records written"
    assert sorted(r["question_id"] for r in records) == sorted(s.question_id for s in samples)
    assert all(r["error"] is False and isinstance(r["stage1"], str) for r in records)
    assert len(reuse) == BATCH and all(not r.error for r in reuse)
    assert all(n > 0 for n in launches.values()), f"kernel launches on the main path: {launches}"
    # the bf16 main path runs K1 and K2 on the tensor cores, never through their fp32-arithmetic variants
    assert all(v == {"mma": launches[name], "fma": 0} for name, v in variants.items()), variants
    # a direct look at the model's output on one stage-1 batch: finite fp32 logits
    batch = EP._stage1_inputs(generator, processor, [s.question for s in samples[:BATCH]],
                              [tiles[s.image_name] for s in samples[:BATCH]], 512)[-1]
    logits, cache, attend = generator.run_prefill(batch, max_new=NEW_TOKENS)
    assert logits.shape == (BATCH, cfg.text.vocab_size) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    # every decode step of the run went through K3 once per layer: replays counted
    assert launches["decode_attention_cuda"] == cfg.text.num_hidden_layers * steps, (launches, steps)
    log(f"  captured decode of the run: {steps} solo steps; {graphs} | {card}")
    eager_and_captured(f"solo (run_decode), bf16 cache, attend {attend}", card, lambda: generator.solo_step(
        logits, cache.clone(), batch.next_pos, gen, attend=attend), NEW_TOKENS)
    del cache
    stage2_lens = sorted({len(r["stage2"]) for r in records})
    log(f"  {len(records)} records written; stage-2 text lengths {stage2_lens[:5]}...")
    log(f"  stage-1 batch: S={batch.input_ids.shape[1]} patches={batch.pixel_values.shape[0]} "
        f"win_mode={batch.vision_meta['win_mode']}")
    for name, secs in phases.items():
        log(f"  {name}: {secs:.2f} s | {card}")
    log(f"  peak memory allocated: {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB of it allocated before the run) "
        f"| {card}")
    log(f"  main-path kernel launches: {launches}; K1/K2 by variant: {variants}")
    return {"flash_segment_attention": launches["segment_attention_cuda"],
            "flash_causal_attention": launches["causal_attention_cuda"],
            "flash_decode_attention": launches["decode_attention_cuda"]}


def same_tokens(a, b):
    """(identical, compared) tokens of two runs' stages (each a list of token rows),
    position by position, the longer row's length compared."""
    assert len(a) == len(b) and all(len(x) == len(y) for x, y in zip(a, b)), "runs of other shapes"
    rows = [(ra, rb) for x, y in zip(a, b) for ra, rb in zip(x, y)]
    return (sum(p == q for ra, rb in rows for p, q in zip(ra, rb)), sum(max(len(ra), len(rb)) for ra, rb in rows))


def run_pipelined(card, env):
    """The pair-pipelined evaluation path at 3B width (see the module docstring,
    phase 6). Returns {kernel name: {"launches_pipelined": n[, "launches_pipelined_int8": n]}}."""
    import torch

    from zoomearth_tpu_torch.agent import episode as EP
    from zoomearth_tpu_torch.eval.infer import record_dict, run_inference
    from zoomearth_tpu_torch.eval.score import evaluation_metrics
    from zoomearth_tpu_torch.models.vlm import vlm_forward
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.ops.sampling import greedy
    from zoomearth_tpu_torch.runtime import generate as G
    from zoomearth_tpu_torch.runtime import pipeline as PL

    cfg, generator, processor, samples, tiles = env.cfg, env.generator, env.processor, env.samples, env.tiles
    L = cfg.text.num_hidden_layers
    gen1 = G.GenerationConfig(max_new_tokens=NEW_TOKENS, temperature=0.0)
    gen2 = G.GenerationConfig(max_new_tokens=PIPE_NEW_TOKENS_2, temperature=0.0)
    kernels = (K1.segment_attention_cuda, K2.causal_attention_cuda, K3.decode_attention_cuda)
    names = ("flash_segment_attention", "flash_causal_attention", "flash_decode_attention")
    loader = lambda s: tiles[s.image_name]  # noqa: E731
    paired_waves = PL.run_paired_waves
    steps = {}  # the last run's decode steps by kind, "pair" and "solo", as its Generator counted them

    def reset():
        for k in kernels:
            k.launches = 0
        for k in kernels[:2]:
            k.variants = dict.fromkeys(k.variants, 0)
        for k in kernels[1:]:
            k.int8_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def run(g, fn):
        """fn() with the counts at 0: (wall seconds, fn's result, the token lists of every stage in
        the order they were read back: stage 1 then stage 2 of each wave or batch)."""
        tokens = []
        g.trim_generated = lambda buf, _fn=g.trim_generated: (tokens.append(_fn(buf)), tokens[-1])[1]
        reset()
        before = dict(g.decode_steps)
        t0 = time.time()
        try:
            out = fn()
        finally:
            del g.trim_generated  # the instance attribute shadowed the class's method
        torch.cuda.synchronize()
        steps.update({k: g.decode_steps[k] - before.get(k, 0) for k in ("pair", "solo")})
        # K3 once per layer per solo step and twice per pair step, captured replays counted
        assert K3.decode_attention_cuda.launches == L * (2 * steps["pair"] + steps["solo"]), (
            K3.decode_attention_cuda.launches, steps)
        return time.time() - t0, out, tokens

    def pipelined(g, path, chosen):
        wall, _, tokens = run(g, lambda: run_inference(g, processor, chosen, path, batch_size=BATCH, gen=gen1,
                                                       stage2_gen=gen2, image_loader=loader, mode="pipelined"))
        return wall, [json.loads(line) for line in open(path)], tokens

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        # (1) the main path of this phase, as a user runs it
        graphs0 = graph_counts(generator)
        wall, records, tokens = pipelined(generator, os.path.join(out_dir, "pipe0.jsonl"), samples)
        launches = {n: k.launches for n, k in zip(names, kernels)}
        variants = {n: dict(k.variants) for n, k in zip(names[:2], kernels[:2])}
        int8_bf16 = {n: k.int8_launches for n, k in zip(names[1:], kernels[1:])}
        steps_pair, peak_dummy = steps["pair"], torch.cuda.max_memory_allocated()
        graphs_main = graph_line(generator, graphs0)
        assert len(records) == PIPE_SAMPLES, f"{len(records)} of {PIPE_SAMPLES} records written"
        assert sorted(r["question_id"] for r in records) == sorted(s.question_id for s in samples)
        assert all(r["error"] is False and isinstance(r["stage2"], str) for r in records)
        assert len(tokens) == 2 * (PIPE_SAMPLES // BATCH) and all(
            len(row) == budget for i, stage in enumerate(tokens) for row in stage
            for budget in ((NEW_TOKENS, PIPE_NEW_TOKENS_2)[i % 2],)), "a stage stopped short of its budget"
        assert all(n > 0 for n in launches.values()), f"kernel launches of the pipelined run: {launches}"
        assert all(v == {"mma": launches[n], "fma": 0} for n, v in variants.items()), variants
        assert int8_bf16 == dict.fromkeys(names[1:], 0), f"int8 entries taken with a bf16 cache: {int8_bf16}"
        waves = PIPE_SAMPLES // BATCH
        # every iteration pairs (bootstrap and drain with a dummy partner); the loop may leave early
        # only at an all-done check, and random weights emit no stop token
        assert steps_pair == (waves + 1) * min(NEW_TOKENS, PIPE_NEW_TOKENS_2), steps_pair
        solo_steps, odd = divmod(launches[names[2]] - 2 * L * steps_pair, L)
        assert odd == 0 and solo_steps == steps["solo"] == waves * (NEW_TOKENS - PIPE_NEW_TOKENS_2), (solo_steps, odd)
        log(f"  {len(records)} records written in {wall:.2f} s; launches {launches}; K1/K2 by variant {variants}; "
            f"{steps_pair} pair steps x 2 x {L} layers + {solo_steps} solo-tail steps x {L} layers of K3 | {card}")
        log(f"  captured decode of the run: {graphs_main} | {card}")

        # (2) the same samples through the sequential cache-reuse path, batch by batch
        by_image = sorted(samples, key=lambda s: s.image_name)  # run_inference's order (group_by_image)
        waves_in = [([s.question for s in by_image[i:i + BATCH]], [loader(s) for s in by_image[i:i + BATCH]])
                    for i in range(0, PIPE_SAMPLES, BATCH)]
        wall_seq, res, tokens_seq = run(generator, lambda: [
            EP.run_episodes(generator, processor, qs, ims, gen=gen1, stage2_gen=gen2, reuse_cache=True)
            for qs, ims in waves_in])
        seq = [record_dict(s, r) for s, r in zip(by_image, (r for batch in res for r in batch))]
        assert [r["question_id"] for r in seq] == [r["question_id"] for r in records]
        same, total = same_tokens(tokens, tokens_seq)
        log(f"  wall: pipelined {wall:.3f} s, sequential run_episodes(reuse_cache=True) {wall_seq:.3f} s over the same "
            f"{PIPE_SAMPLES} samples ({PIPE_SAMPLES / wall:.3f} and {PIPE_SAMPLES / wall_seq:.3f} samples/s) | {card}")
        log(f"  tokens identical between pipelined and sequential: {same} of {total} ({same / total:.4f}; bf16 at 3B "
            f"width with random weights: near-flat logits, not asserted) | {card}")

        # (3) one wave (bootstrap and drain, each a pair with the dummy partner) with every Generator
        # stage between two device synchronizations: the first wave's samples, so its stage-1 tokens
        # must be the main run's
        one = by_image[:BATCH]
        spent = {name: [0.0, 0] for name in ("run_prefill", "run_chunk_prefill", "run_decode_pair", "run_decode")}
        for name in spent:
            def timed(*a, _fn=getattr(generator, name), _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                spent[_name][0] += time.perf_counter() - t0
                spent[_name][1] += 1
                return out
            setattr(generator, name, timed)
        try:
            wall_t, _, again = pipelined(generator, os.path.join(out_dir, "pipe_timed.jsonl"), one)
        finally:
            for name in spent:
                delattr(generator, name)  # the instance attributes shadow the class's methods
        peak_dummy1, steps_t = torch.cuda.max_memory_allocated(), steps["pair"]
        assert again[0] == tokens[0], "the pipelined run is not repeatable"
        assert steps_t == 2 * min(NEW_TOKENS, PIPE_NEW_TOKENS_2) and spent["run_decode"][1] == 1, (steps_t, spent)
        in_stages = sum(t for t, _ in spent.values())
        log(f"  timed pipelined run of one wave ({BATCH} samples): wall {wall_t:.3f} s; " + "; ".join(
            f"{name} {t:.3f} s in {n} calls" for name, (t, n) in spent.items()) + f" | {card}")
        log(f"  per step, captured (each call's first, eager step and its capture included): pair "
            f"{1e3 * spent['run_decode_pair'][0] / steps_t:.3f} ms ({2 * BATCH} rows, two caches), "
            f"solo {1e3 * spent['run_decode'][0] / (NEW_TOKENS - PIPE_NEW_TOKENS_2):.3f} ms ({BATCH} rows) | {card}")
        log(f"  host preparation with the device idle (image resize and crop, tokenize, patchify, trim; everything "
            f"outside the Generator's stages): {wall_t - in_stages:.3f} s of the wave's {wall_t:.3f} s, share "
            f"{(wall_t - in_stages) / wall_t:.4f} | {card}")

        # (4) the same wave with edges="solo": no dummy partner's cache at the bootstrap and the drain.
        # run_episodes_pipelined takes the runner's default, so the runner is wrapped for this pass.
        PL.run_paired_waves = functools.partial(paired_waves, edges="solo")
        try:
            wall_solo, _, tokens_solo = pipelined(generator, os.path.join(out_dir, "pipe_solo.jsonl"), one)
        finally:
            PL.run_paired_waves = paired_waves
        peak_solo1 = torch.cuda.max_memory_allocated()
        assert steps["pair"] == 0, "edges='solo' over one wave pairs nothing"
        same_s, total_s = same_tokens(again, tokens_solo)
        log(f"  peak memory allocated: the {waves}-wave run {peak_dummy / 2**30:.3f} GiB; one wave, edges='dummy' "
            f"{peak_dummy1 / 2**30:.3f} GiB, edges='solo' {peak_solo1 / 2**30:.3f} GiB (weights and the slice's "
            f"leftovers included; one cache of {BATCH} rows x {generator.max_cache_len} slots is "
            f"{cache_bytes(generator, BATCH) / 2**30:.3f} GiB); edges='solo' wall {wall_solo:.3f} s, tokens identical "
            f"to edges='dummy' {same_s} of {total_s} | {card}")

        # (5) the first pair step's logits against the solo step's, on one stage-1 batch paired with itself
        qs, ims = [s.question for s in samples[:BATCH]], [loader(s) for s in samples[:BATCH]]
        batch = EP._stage1_inputs(generator, processor, qs, ims, 512)[-1]
        la, ca, aa = generator.run_prefill(batch, max_new=NEW_TOKENS)
        cb, cs = ca.clone(), ca.clone()
        with torch.inference_mode():
            tok = greedy(la)
            pos3 = torch.as_tensor(batch.next_pos, device=la.device).long()[None, :, None].expand(3, BATCH, 1)
            solo_logits = vlm_forward(env.params, cfg, tok[:, None], pos3, attn_positions=cs.length[:, None],
                                      cache=cs, attend_len=aa)[0][:, 0]
        _, _, pa, _, _, _, pb, _ = generator.run_decode_pair((la, ca, batch.next_pos, aa, None),
                                                             (la.clone(), cb, batch.next_pos, aa, None), steps=1)
        torch.cuda.synchronize()
        err = max(max_err(pa, solo_logits), max_err(pb, solo_logits))
        agree = float(((pa.argmax(-1) == solo_logits.argmax(-1)) & (pb.argmax(-1) == solo_logits.argmax(-1)))
                      .float().mean())
        log(f"  first pair step's logits vs the solo step's: max_abs_err {err:.3e} (tol {TOL_PAIR_LOGITS}; max |logit| "
            f"{solo_logits.abs().max().item():.2f}); rows whose argmax agrees {agree:.3f} | {card}")
        assert err <= TOL_PAIR_LOGITS and bool(torch.isfinite(pa).all() and torch.isfinite(pb).all())
        assert pa.shape == (BATCH, cfg.text.vocab_size) and pa.dtype == torch.float32
        del la, ca, cb, cs, pa, pb, solo_logits
        # the pair step (16 rows, two caches) and the solo step (8 rows) eagerly and captured, at the
        # stage-1 batch's shapes
        la, ca, aa = generator.run_prefill(batch, max_new=NEW_TOKENS)
        eager_and_captured(f"pair (run_decode_pair), two bf16 caches, attend {aa}", card, lambda: generator.pair_step(
            (la, ca.clone(), batch.next_pos, aa, None), (la, ca.clone(), batch.next_pos, aa, None),
            steps=PIPE_NEW_TOKENS_2), PIPE_NEW_TOKENS_2)
        eager_and_captured(f"solo (run_decode), bf16 cache, attend {aa}", card, lambda: generator.solo_step(
            la, ca.clone(), batch.next_pos, gen1, attend=aa), NEW_TOKENS)
        del la, ca

        # (6) the int8 KV cache: K2's and K3's int8 entries on a path
        g8 = G.Generator(env.params, cfg, max_cache_len=4096, cache_dtype=torch.int8)
        wall8, rec8, tokens8 = pipelined(g8, os.path.join(out_dir, "pipe_int8.jsonl"), by_image[:BATCH])
        launches8 = {n: k.launches for n, k in zip(names, kernels)}
        int8 = {n: k.int8_launches for n, k in zip(names[1:], kernels[1:])}
        assert len(rec8) == BATCH and all(r["error"] is False for r in rec8)
        assert int8 == {n: launches8[n] for n in names[1:]} and all(n > 0 for n in int8.values()), (int8, launches8)
        same8, total8 = same_tokens(tokens[:2], tokens8)
        log(f"  int8 KV cache, {BATCH} samples pipelined: {wall8:.3f} s; launches {launches8}, all of K2's and K3's "
            f"through the int8 entry; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (one int8 cache "
            f"{cache_bytes(g8, BATCH) / 2**30:.3f} GiB); tokens identical to the bf16 cache's {same8} of {total8} "
            f"| {card}")
        # wrong scales would give finite, wrong tokens: the int8 cache's error is far from flipping one
        # token in ten, even on these near-flat logits
        assert same8 >= 0.9 * total8, f"int8 cache: only {same8} of {total8} tokens equal the bf16 cache's"
        # K2 and K3 against their plain versions on a cache that this path's prefill has just
        # quantized, in the forms the decoder hands them: K2 the whole 4096-row cache, K3 the
        # [:, :, :attend] prefix views of the values and of the fp32 scales
        t = cfg.text
        l8, c8, a8 = g8.run_prefill(batch, max_new=NEW_TOKENS)
        eager_and_captured(f"solo (run_decode), int8 cache, attend {a8}", card, lambda: g8.solo_step(
            l8, c8.clone(), batch.next_pos, gen1, attend=a8), NEW_TOKENS)
        del l8

        with torch.inference_mode():
            gq = torch.Generator(device="cuda").manual_seed(1)
            S8 = batch.input_ids.shape[1]
            q8 = torch.randn((BATCH, S8, t.num_attention_heads, t.head_dim), generator=gq, device="cuda").bfloat16()
            q1 = q8[:, :1].contiguous()
            pos8 = torch.arange(S8, device="cuda")[None].expand(BATCH, S8)
            for layer in (0, L - 1):
                k8, v8, ks8, vs8 = c8.layer(layer)
                assert_scale_views_as_is(ks8, vs8)
                held_on_path(f"K2 int8 on the path's cache, layer {layer}, B={BATCH} S={S8} T={k8.shape[2]}",
                     K2.causal_attention_cuda(q8, k8, v8, pos8, c8.length, ks8, vs8),
                     K2.flash_causal_attention_plain(q8, k8, v8, pos8, c8.length, ks8, vs8))
                assert a8 is not None and a8 < k8.shape[2], a8
                view = tuple(x[:, :, :a8] for x in (k8, v8, ks8, vs8))
                assert_scale_views_as_is(view[2], view[3])
                held_on_path(f"K3 int8 on the path's cache, layer {layer}, attend {a8} view of T={k8.shape[2]}",
                     K3.decode_attention_cuda(q1, view[0], view[1], c8.length, view[2], view[3]),
                     K3.flash_decode_attention_plain(q1, view[0], view[1], c8.length, view[2], view[3]))
        del c8, q8, q1, k8, v8, ks8, vs8, view
        del g8

        # (7) the scorer over the jsonl the pipelined run wrote
        metrics = evaluation_metrics(os.path.join(out_dir, "pipe0.jsonl"), verbose=False)
        assert metrics["n"] == PIPE_SAMPLES and 0.0 <= metrics["overall_acc2"] <= 1.0 and "per_type" in metrics
        log(f"  scorer: n {metrics['n']}, overall_acc1 {metrics['overall_acc1']:.3f}, overall_acc2 "
            f"{metrics['overall_acc2']:.3f} (random weights), wordnet backend {metrics['wordnet_backend']}")
    out = {n: {"launches_pipelined": launches[n]} for n in names}
    for n in names[1:]:
        out[n]["launches_pipelined_int8"] = int8[n]
    return out


# the reference bench's big-batch shape for the split prefill (bench.py:291-301: R = 48 at B >= 96)
SPLIT_B, SPLIT_S, SPLIT_T, SPLIT_R = 96, 768, 1536, 48
SPLIT_GRID, SPLIT_IMAGES = (1, 36, 36), 8  # 504 px images (324 tokens a row), row b showing image b % 8
SPLIT_NEW = 32  # greedy tokens decoded after each prefill
RIGHT_NEW_1, RIGHT_NEW_2, RIGHT_CHUNK = 160, 32, 300  # the right-sized episode: budgets, stage-2 text chunk
SPLIT_AGREE = 0.99  # share of greedy tokens the split's decode must share with the one-shot's (bf16)


def split_batch(cfg, params, B, S, grid, images):
    """An embeds batch of B rows in the S bucket: row b is random text around image
    b % images (random patches through the port's ViT: the embeds path, vision_meta
    None, the embeddings a device tensor in row order)."""
    import numpy as np
    import torch

    from zoomearth_tpu_torch.models.vit import meta_to_device
    from zoomearth_tpu_torch.models.vlm import compute_vision_embeds
    from zoomearth_tpu_torch.runtime.generate import prepare_batch

    rng = np.random.default_rng(7)
    tok = cfg.tokens
    n = grid[0] * grid[1] * grid[2] // cfg.vision.merge_unit
    top = min(vars(tok).values())  # text ids below every special id
    pvs = [rng.standard_normal((grid[0] * grid[1] * grid[2], cfg.vision.patch_dim)).astype(np.float32)
           for _ in range(images)]
    image_ids = [tok.vision_start] + [tok.image_pad] * n + [tok.vision_end]
    imgs = prepare_batch(cfg, [image_ids] * images, [[(pv, grid)] for pv in pvs], length_buckets=(len(image_ids),),
                         patch_buckets=(images * len(pvs[0]),))
    with torch.inference_mode():
        emb = compute_vision_embeds(params, cfg, torch.as_tensor(imgs.pixel_values, device="cuda"),
                                    meta_to_device(imgs.vision_meta, "cuda"), int(imgs.vision_meta["win_mode"]))
    per_image = emb.reshape(images, n, -1)
    free = S - len(image_ids) - 1
    seqs = []
    for b in range(B):
        head = [int(t) for t in rng.integers(1, top, size=8)]
        tail = [int(t) for t in rng.integers(1, top, size=int(rng.integers(free // 2, free - len(head) + 1)))]
        seqs.append([tok.im_start] + head + image_ids + tail)
    batch = prepare_batch(cfg, seqs, [[(pvs[0][:, :1], grid)] for _ in range(B)], length_buckets=(S,),
                          patch_buckets=(B * len(pvs[0]),))
    batch.pixel_values = torch.cat([per_image[b % images] for b in range(B)])
    batch.vision_meta = None
    return batch


def hold_caches(label, cache, ref):
    """Every layer's keys and values of `cache` against `ref`'s, row by row (one slot of
    one head a row) over the slots below each row's length; the lengths exactly."""
    import torch

    assert torch.equal(cache.length, ref.length), label
    T = cache.max_len
    valid = (torch.arange(T, device=cache.length.device)[None] < cache.length[:, None].long())
    valid = valid[:, None, :].expand(-1, cache.k[0].shape[1], -1)
    worst, err = 0.0, 0.0
    for a, b in zip(cache.k + cache.v, ref.k + ref.v):
        o, r = a[valid].float(), b[valid].float()
        worst = max(worst, row_ratios(o, r).max().item())
        err = max(err, (o - r).abs().max().item())
    log(f"  {label}: every layer's k and v over the valid slots, max_abs_err {err:.3e}, worst row's error over its "
        f"tolerance {worst:.3f} ({ROW_TOL})")
    if worst > 1:
        raise AssertionError(f"{label}: the caches disagree (worst row {worst:.3f} of its tolerance)")


def check_tiny_split_prefill():
    """The tiny config in fp32 on the card: a Generator with prefill_split_rows=2 over 4
    embeds rows gives the one-shot prefill's first logits (1e-5) and its greedy tokens
    exactly."""
    import torch

    from zoomearth_tpu_torch.config import VLMConfig
    from zoomearth_tpu_torch.models.params import init_vlm_params
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator

    cfg = VLMConfig.tiny()
    params = init_vlm_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = split_batch(cfg, params, 4, 64, (1, 4, 4), 2)
    one, split = (Generator(params, cfg, max_cache_len=128, prefill_split_rows=r) for r in (0, 2))
    gen = GenerationConfig(max_new_tokens=16)
    err = max_err(split.run_prefill(batch, max_new=16)[0], one.run_prefill(batch, max_new=16)[0])
    same = split.generate(batch, gen) == one.generate(batch, gen)
    log(f"  tiny fp32, 4 embeds rows in slices of 2: first logits max_abs_err {err:.3e} against the one-shot prefill "
        f"(tol 1e-5), greedy tokens {'identical' if same else 'DIFFER'}")
    if not (err <= 1e-5 and same):
        raise AssertionError("the split prefill at the tiny config differs from the one-shot prefill")


def run_split_prefill(card, env):
    """[split-prefill] (module docstring, phase 7): the split-row prefill and the
    right-sized cache on the slice's 3B weights. Returns {kernel name:
    {"launches_split_prefill": n}}."""
    import gc

    import numpy as np
    import torch

    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator, prepare_continuation

    check_tiny_split_prefill()
    cfg, params = env.cfg, env.params
    L = cfg.text.num_hidden_layers
    kernels = {"flash_causal_attention": K2.causal_attention_cuda, "flash_decode_attention": K3.decode_attention_cuda}
    totals = dict.fromkeys(kernels, 0)
    batch = split_batch(cfg, params, SPLIT_B, SPLIT_S, SPLIT_GRID, SPLIT_IMAGES)
    weights = torch.cuda.memory_allocated()
    gens = {"one-shot": Generator(params, cfg, max_cache_len=SPLIT_T),
            "split": Generator(params, cfg, max_cache_len=SPLIT_T, prefill_split_rows=SPLIT_R)}

    def measured(fn):
        """fn() with the counts at 0: (its result, seconds, peak GiB over what was
        allocated before, K2 launches and the rows of each, K3 launches)."""
        gc.collect()
        torch.cuda.empty_cache()
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        n = {name: k.launches for name, k in kernels.items()}
        for name in totals:
            totals[name] += n[name]
        return out, s, (torch.cuda.max_memory_allocated() - base) / 2**30, n

    # in turns, one-shot then split twice: the first pair warms up, the second is kept
    runs = {}
    for name in ("one-shot", "split", "one-shot", "split"):
        runs.pop(name, None)
        runs[name] = measured(lambda g=gens[name]: g.run_prefill(batch, max_new=SPLIT_NEW))
    (logits1, cache1, attend1), s1, peak1, n1 = runs["one-shot"]
    (logits2, cache2, attend2), s2, peak2, n2 = runs["split"]
    log(f"  B={SPLIT_B} S={SPLIT_S} max_cache_len {SPLIT_T} (cache {cache_bytes(gens['split'], SPLIT_B) / 2**30:.2f} GiB), "
        f"weights and what the slice holds {weights / 2**30:.2f} GiB: one-shot prefill {s1 * 1e3:.1f} ms, peak "
        f"{peak1:.2f} GiB over what was allocated before it (total {(weights + peak1 * 2**30) / 2**30:.2f} GiB); split "
        f"into {SPLIT_B // SPLIT_R} slices of {SPLIT_R} rows {s2 * 1e3:.1f} ms ({s2 / s1:.3f}x), peak {peak2:.2f} GiB "
        f"(total {(weights + peak2 * 2**30) / 2**30:.2f} GiB) | {card}")
    log(f"  K2 launches: one-shot {n1['flash_causal_attention']}, split {n2['flash_causal_attention']}")
    assert n1["flash_causal_attention"] == L and n2["flash_causal_attention"] == 2 * L, (n1, n2)
    assert peak2 < peak1, (peak1, peak2)
    assert attend1 == attend2 and cache2.max_len == SPLIT_T
    held_on_path("split prefill's first logits against the one-shot's, row by row", logits2, logits1)
    hold_caches("split prefill's cache against the one-shot's", cache2, cache1)
    # K2 and K3 against their plain versions in the forms this path hands them, on the keys and values the split
    # prefill wrote: K2 over a row view (the last slice's rows) of the full cache, K3 over the attend-prefix views of
    # the whole cache that the decode below reads
    t = cfg.text
    with torch.inference_mode():
        gq = torch.Generator(device="cuda").manual_seed(2)
        view = cache2.rows(slice(SPLIT_B - SPLIT_R, SPLIT_B))
        qs = torch.randn((SPLIT_R, SPLIT_S, t.num_attention_heads, t.head_dim), generator=gq, device="cuda").bfloat16()
        q1 = torch.randn((SPLIT_B, t.num_attention_heads, t.head_dim), generator=gq, device="cuda").bfloat16()
        pos = torch.arange(SPLIT_S, device="cuda")[None].expand(SPLIT_R, SPLIT_S)
        assert attend2 is not None and attend2 < SPLIT_T, attend2
        for layer in (0, L - 1):
            k, v, _, _ = view.layer(layer)
            assert k.data_ptr() == cache2.k[layer][SPLIT_B - SPLIT_R].data_ptr(), "the row view is not a view"
            held_on_path(f"K2 on the split prefill's row view, layer {layer}, rows {SPLIT_B - SPLIT_R}-{SPLIT_B - 1} "
                         f"of B={SPLIT_B}, S={SPLIT_S} T={k.shape[2]}",
                         K2.causal_attention_cuda(qs, k, v, pos, view.length),
                         K2.flash_causal_attention_plain(qs, k, v, pos, view.length))
            k, v = (x[:, :, :attend2] for x in cache2.layer(layer)[:2])
            held_on_path(f"K3 on the split prefill's cache, layer {layer}, attend {attend2} view of T={SPLIT_T}, "
                         f"B={SPLIT_B}",
                         K3.decode_attention_cuda(q1, k, v, cache2.length),
                         K3.flash_decode_attention_plain(q1, k, v, cache2.length))
        del view, qs, q1, pos, k, v

    gen = GenerationConfig(max_new_tokens=SPLIT_NEW)
    toks = {}
    for name, (logits, cache, attend) in (("one-shot", (logits1, cache1, attend1)), ("split", (logits2, cache2, attend2))):
        out, _, _, n = measured(lambda: gens[name].run_decode(logits, cache, batch.next_pos, gen, attend=attend)[0])
        toks[name] = gens[name].trim_generated(out.cpu().numpy())
    same, total = same_tokens([toks["split"]], [toks["one-shot"]])
    share = same / total
    log(f"  greedy decode of {SPLIT_NEW} tokens after each: {share:.4f} of the split's tokens equal the one-shot's "
        f"(at least {SPLIT_AGREE}); rows identical {sum(a == b for a, b in zip(toks['split'], toks['one-shot']))} "
        f"of {SPLIT_B}")
    assert share >= SPLIT_AGREE, share
    del logits, cache, logits1, cache1, logits2, cache2, runs

    # right_size_cache: one stage-1 / stage-2 episode batch, right-sized against full size
    right = Generator(params, cfg, max_cache_len=SPLIT_T, right_size_cache=True, prefill_split_rows=SPLIT_R)
    full = gens["split"]
    gen1, gen2 = GenerationConfig(max_new_tokens=RIGHT_NEW_1), GenerationConfig(max_new_tokens=RIGHT_NEW_2)
    episode = {}
    for name, g in (("full-size", full), ("right-sized", right)):
        rng = np.random.default_rng(11)  # the same stage-2 chunks for both
        (out1, c1), s_1, peak_1, _ = measured(lambda g=g: g.generate(batch, gen1, return_cache=True))
        bytes1 = sum(t.numel() * t.element_size() for t in c1.k + c1.v)
        keep = np.asarray([int(batch.lengths[b]) + len(out1[b]) for b in range(SPLIT_B)], np.int32)
        starts = [int(batch.next_pos[b]) + len(out1[b]) for b in range(SPLIT_B)]
        chunk = [[int(t) for t in rng.integers(1, min(vars(cfg.tokens).values()), size=RIGHT_CHUNK)]
                 for _ in range(SPLIT_B)]
        bc = prepare_continuation(cfg, chunk, [[] for _ in range(SPLIT_B)], starts)
        (out2, c2), s_2, peak_2, _ = measured(lambda g=g: g.continue_generate(c1, bc, keep, gen2, return_cache=True))
        bytes2 = sum(t.numel() * t.element_size() for t in c2.k + c2.v)
        episode[name] = (out1, out2, c1.max_len, c2.max_len, bytes1, bytes2)
        log(f"  {name}: stage-1 cache {c1.max_len} slots, {bytes1 / 2**30:.2f} GiB; generate {s_1:.2f} s, peak "
            f"{peak_1:.2f} GiB over what was allocated before; stage-2 cache {c2.max_len} slots, {bytes2 / 2**30:.2f} "
            f"GiB; continue_generate {s_2:.2f} s, peak {peak_2:.2f} GiB over what was allocated before | {card}")
        del c1, c2
    rs, fs = episode["right-sized"], episode["full-size"]
    need1 = SPLIT_S + RIGHT_NEW_1
    assert rs[2] == next(b for b in (256, 512, 768, 1024, 1280, 1536) if need1 <= b) < SPLIT_T == fs[2], (rs, fs)
    assert rs[2] < rs[3] <= SPLIT_T, rs
    (same1, total1), (same2, total2) = same_tokens([rs[0]], [fs[0]]), same_tokens([rs[1]], [fs[1]])
    share1, share2 = same1 / total1, same2 / total2
    log(f"  right-sized against full-size: stage-1 tokens {share1:.4f} equal, stage-2 {share2:.4f} (at least "
        f"{SPLIT_AGREE}); the stage-1 cache {rs[4] / fs[4]:.3f} of the full-size one's bytes")
    assert share1 >= SPLIT_AGREE and share2 >= SPLIT_AGREE, (share1, share2)
    del gens, right, full
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  [split-prefill] launches: {totals}")
    return {n: {"launches_split_prefill": v} for n, v in totals.items()}


def run_serving(card, env):
    """The serving path at 3B width (see the module docstring, phase 8). Returns
    {kernel name: {"launches_serving": n[, "launches_serving_int8": n]}} and {kernel name: [the
    checks of that kernel against its plain version on this path's own pools]}."""
    import copy
    import http.client
    import threading

    import numpy as np
    import torch

    from zoomearth_tpu_torch.eval.client import ChatClient, encode_data_url
    from zoomearth_tpu_torch.image.geometry import resize_image
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.ops.quant import qdot, quantize_decoder_int8, quantized_bytes
    from zoomearth_tpu_torch.scripts.timing import time_in_turns
    from zoomearth_tpu_torch.serve import engine as ENG
    from zoomearth_tpu_torch.serve import episodes as SE
    from zoomearth_tpu_torch.serve.engine import Request, ServingEngine
    from zoomearth_tpu_torch.serve.server import OpenAIServer
    from zoomearth_tpu_torch.train.datagen import generate_records

    cfg, processor, tiles = env.cfg, env.processor, env.tiles
    samples = env.samples[:SERVE_EPISODES]
    kernels = (K1.segment_attention_cuda, K2.causal_attention_cuda, K3.decode_attention_cuda)
    names = ("flash_segment_attention", "flash_causal_attention", "flash_decode_attention")
    SE.extract_bboxes = lambda text, scale=1.0: [[2200, 2200, 2380, 2350]]  # random weights emit no bbox

    def reset():
        for k in kernels:
            k.launches = 0
        for k in kernels[:2]:
            k.variants = dict.fromkeys(k.variants, 0)
        for k in kernels[1:]:
            k.int8_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def counts():
        return ({n: k.launches for n, k in zip(names, kernels)}, {n: dict(k.variants) for n, k in zip(names[:2], kernels[:2])},
                {n: k.int8_launches for n, k in zip(names[1:], kernels[1:])})

    def engine_for(params, cache_dtype=None):
        return ServingEngine(params, cfg, max_slots=SERVE_SLOTS, max_seq_len=SERVE_SEQ_LEN, decode_chunk=SERVE_CHUNK,
                             cache_dtype=cache_dtype)

    def contained(engine):
        """The failures the scheduler caught and served on after: the smoke allows none."""
        return {key: engine.stats.get(key, 0) for key in ("errors", "admission_retries", "pump_errors")}

    def watch(engine, seen):
        """Shadow the engine's device routines (instance attributes over the class's methods)
        and the ViT pass it calls, to keep for every distinct shape the host arguments of its
        last call: what held_on_pool then gives the kernels. Returns the function that undoes it."""
        pool, full, compact = engine._pool_prefill, engine._decode_steps, engine._decode_steps_compact
        vision = ENG.compute_vision_embeds

        def pool_prefill(slot_idx, ids, chunk_lens, keep_lens, *a):
            seen["k2"][ids.shape] = (slot_idx.copy(), keep_lens.copy())
            return pool(slot_idx, ids, chunk_lens, keep_lens, *a)

        def decode_steps(active, temps, *, n_steps, attend_len=None):
            seen["k3"][(engine.max_slots, attend_len or SERVE_SEQ_LEN, "in place on the pool")] = None
            return full(active, temps, n_steps=n_steps, attend_len=attend_len)

        def decode_steps_compact(slot_idx, active, temps, *, n_steps, attend_len=None):
            seen["k3"][(len(slot_idx), attend_len or SERVE_SEQ_LEN, "gathered copy")] = slot_idx.copy()
            return compact(slot_idx, active, temps, n_steps=n_steps, attend_len=attend_len)

        def vision_embeds(params, cfg_, pv, meta, **kw):
            seen["k1"][pv.shape[0]] = meta["seg_full"]
            return vision(params, cfg_, pv, meta, **kw)

        engine._pool_prefill, engine._decode_steps = pool_prefill, decode_steps
        engine._decode_steps_compact, ENG.compute_vision_embeds = decode_steps_compact, vision_embeds

        def undo():
            del engine._pool_prefill, engine._decode_steps, engine._decode_steps_compact
            ENG.compute_vision_embeds = vision
        return undo

    def held_on_pool(engine, seen, where):
        """K1, K2 and K3 against their plain versions in every form this engine's run gave them,
        on the engine's own pool as the run left it (the model's keys and values, int8 with their
        scale rows): K2 over the gathered copy of the rows of each (row bucket, length bucket) at
        that batch's kept lengths, K3 over the attend_len prefix views of each (rows, span) met,
        gathered or in place, at the rows' own lengths, K1 over fused-qkv views at each padded
        patch count with that pass's segment ids; first and last layer. Called with the pump
        stopped and after the run's counts were read. Returns {kernel name: [checks]}."""
        t, L = cfg.text, cfg.text.num_hidden_layers
        H, D, T = t.num_attention_heads, t.head_dim, engine.max_seq_len
        Hv, Dv = cfg.vision.num_heads, cfg.vision.hidden_size // cfg.vision.num_heads
        gq = torch.Generator(device="cuda").manual_seed(3)
        randn = lambda *shape: torch.randn(shape, generator=gq, device="cuda").bfloat16()  # noqa: E731
        kind = "int8" if engine.cache.quantized else "bf16"
        checks = {n: [] for n in names}
        assert seen["k1"] and seen["k2"] and seen["k3"], seen
        with engine._device_scope():
            cache = engine.cache
            for (RB, S), (slot_idx, keep_lens) in sorted(seen["k2"].items()):
                cidx = engine._tensor(np.clip(slot_idx, 0, engine.max_slots - 1), torch.int64)
                keep = engine._tensor(keep_lens, torch.int32)
                g = engine._gather_rows(cache, cidx, keep)
                q = randn(RB, S, H, D)
                pos = keep.long()[:, None] + torch.arange(S, device="cuda")[None]
                for layer in (0, L - 1):
                    k, v, ks, vs = g.layer(layer)
                    if ks is not None:
                        assert_scale_views_as_is(ks, vs)
                    checks[names[1]].append(held_on_path(
                        f"K2 {kind} {where}, layer {layer}, gathered rows {slot_idx.tolist()} R={RB} S={S} T={T}, "
                        f"kept {keep_lens.tolist()}", K2.causal_attention_cuda(q, k, v, pos, keep + S, ks, vs),
                        K2.flash_causal_attention_plain(q, k, v, pos, keep + S, ks, vs)))
            for (R, span, how), slot_idx in sorted(seen["k3"].items(), key=lambda kv: kv[0]):
                if slot_idx is None:
                    g = cache
                else:
                    cidx = engine._tensor(np.clip(slot_idx, 0, engine.max_slots - 1), torch.int64)
                    g = engine._gather_rows(cache, cidx, cache.length[cidx])
                kvl = g.length.clamp(1, span)
                q1 = randn(R, 1, H, D)
                for layer in (0, L - 1):
                    view = tuple(x[:, :, :span] if x is not None else None for x in g.layer(layer))
                    if view[2] is not None:
                        assert_scale_views_as_is(view[2], view[3])
                    checks[names[2]].append(held_on_path(
                        f"K3 {kind} {where}, layer {layer}, {how}, R={R}, attend {span} view of T={T}, kv_len "
                        f"{kvl.tolist()}", K3.decode_attention_cuda(q1, view[0], view[1], kvl, view[2], view[3]),
                        K3.flash_decode_attention_plain(q1, view[0], view[1], kvl, view[2], view[3])))
            for S, seg in sorted(seen["k1"].items()):
                qkv = randn(S, 3, Hv, Dv)
                q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
                out = K1.segment_attention_cuda(q, k, v, seg)
                # the plain version is dense in fp32 (heads x S x S): four heads at a time
                ref = torch.cat([K1.flash_segment_attention_plain(q[:, h:h + 4], k[:, h:h + 4], v[:, h:h + 4], seg)
                                 for h in range(0, Hv, 4)], dim=1)
                checks[names[0]].append(edge_check(
                    f"K1 {where}, fused-qkv views, S={S} (patch bucket), {int((seg != K1.PAD_SEG).sum())} live patches "
                    f"in {int(seg[seg != K1.PAD_SEG].unique().numel())} images", out, ref))
                del qkv, out, ref
        return checks

    def episodes(engine):
        """run_episodes_served over the samples on a running engine (no server holds its token hook):
        (wall seconds, results, the tokens of every request by id, as the engine streamed them). The
        call runs in a thread of its own so that this one can bound the wait: a pump that lost a decode
        chunk would leave it waiting for an hour."""
        tokens, out = {}, []
        engine.on_tokens = lambda rid, toks: tokens.setdefault(rid, []).extend(toks)
        t0 = time.time()
        runner = threading.Thread(daemon=True, target=lambda: out.append(SE.run_episodes_served(
            engine, processor, [s.question for s in samples], [tiles[s.image_name] for s in samples],
            max_new_tokens=NEW_TOKENS, stage2_max_tokens=PIPE_NEW_TOKENS_2, temperature=0.0,
            image_keys=[s.image_name for s in samples])))
        runner.start()
        while runner.is_alive() and time.time() - t0 < SERVE_WAIT_S and not any(contained(engine).values()):
            runner.join(timeout=0.05)
        assert out and not any(contained(engine).values()), (
            f"run_episodes_served after {time.time() - t0:.1f} s: returned {bool(out)}, the scheduler contained "
            f"{contained(engine)} (its tracebacks are on stderr), stats {engine.stats}")
        torch.cuda.synchronize()
        return time.time() - t0, out[0], tokens

    def held_to(engine, res, tokens, launches, variants):
        """What every episodes run must show, whatever the cache's dtype."""
        st = engine.stats
        assert len(res) == SERVE_EPISODES and all(r is not None and r.error is False for r in res), "an episode failed"
        assert all(isinstance(r.stage2, str) and r.bbox == [2200, 2200, 2380, 2350] for r in res)
        assert all(len(tokens[f"ep{i}-s1"]) == NEW_TOKENS and len(tokens[f"ep{i}-s2"]) == PIPE_NEW_TOKENS_2
                   for i in range(SERVE_EPISODES)), "a stage stopped short of its budget"
        assert all(n > 0 for n in launches.values()), f"kernel launches of the serving run: {launches}"
        assert all(v == {"mma": launches[n], "fma": 0} for n, v in variants.items()), variants
        assert st["prefix_hits"] > 0 and st["prefix_saves"] > 0, st
        assert st["prefills"] < st["prefill_rows"], f"admissions were not batched: {st}"
        assert st["decode_device_row_steps"] < SERVE_SLOTS * st["decode_steps"], f"no compact decode chunk ran: {st}"
        assert not any(contained(engine).values()), f"the scheduler caught and served on after {contained(engine)}"
        assert not engine.active.any() and not engine.held, (st, engine.held)
        assert not any(s.held or s.request is not None for s in engine.slots)
        L = cfg.text.num_hidden_layers
        assert launches[names[1]] == L * st["prefills"] and launches[names[2]] == L * st["decode_steps"], (launches, st)

    # (1) the endpoint: real HTTP against the pump thread; an answer without text streams no
    # content event, so the endpoint's tokenizer reads every id as a letter
    reset()
    engine = engine_for(env.params)
    legible = copy.copy(processor)
    legible.tokenizer = legible_tokenizer(cfg.tokens)
    server = OpenAIServer(engine, legible, host="127.0.0.1", port=0)
    # the tokens are read beside the server's router too, by request in order of arrival
    routed, route = {}, engine.on_tokens
    engine.on_tokens = lambda rid, toks: (routed.setdefault(rid, []).append(list(toks)), route(rid, toks))
    seen = {"k1": {}, "k2": {}, "k3": {}}
    undo = watch(engine, seen)
    server.start()
    try:
        client = ChatClient(f"http://127.0.0.1:{server.port}", timeout=300)
        t0 = time.time()
        text = client.create([{"role": "user", "content": "What can you see from orbit?"}], max_tokens=24, temperature=0.0)
        t_text = time.time() - t0
        url = encode_data_url(resize_image(tiles["tile0.png"], 512))
        t0 = time.time()
        answer = client.create([{"role": "user", "content": [{"type": "image_url", "image_url": {"url": url}},
                                                           {"type": "text", "text": "what is in this tile?"}]}],
                             max_tokens=24, temperature=0.0)
        t_image = time.time() - t0
        assert 0 < len(text) <= 24 and 0 < len(answer) <= 24 and text.isalpha() and answer.isalpha(), (text, answer)
        try:  # 2200 byte-level tokens: over max_seq_len, refused at submit, an HTTP 400 for the client
            client.create([{"role": "user", "content": "w " * 1100}], max_tokens=8)
        except RuntimeError as e:
            assert "exceeds" in str(e), e
        else:
            raise AssertionError("an over-long prompt was served")
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=300)
        t0 = time.time()
        conn.request("POST", "/v1/chat/completions", json.dumps({
            "messages": [{"role": "user", "content": "What can you see from orbit?"}], "max_tokens": 24,
            "temperature": 0.0, "stream": True}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        events, arrived = [], []  # each event as it comes off the socket, with its time
        for line in iter(resp.readline, b""):
            if line.startswith(b"data: "):
                events.append(line[len(b"data: "):].decode().strip())
                arrived.append(time.time() - t0)
        conn.close()
        t_sse = time.time() - t0
        chunks = [json.loads(e) for e in events[:-1]]
        content = [(c["choices"][0]["delta"]["content"], at) for c, at in zip(chunks, arrived)
                   if "content" in c["choices"][0]["delta"]]
        streamed = "".join(text_ for text_, _ in content)
        assert resp.status == 200 and events[-1] == "[DONE]" and chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
        # the served request after the refusal, and the same prompt twice: greedy, so the same answer
        assert streamed == text, (streamed, text)
        first, _, last = routed.values()
        assert sum(first, []) == sum(last, []) and len(sum(last, [])) == 24, (first, last)
        # incrementally, over HTTP: the prefill's first token, then one event per decode chunk, each
        # on the wire before the next chunk's steps were done
        assert len(content) == len(last) >= 1 + 23 // SERVE_CHUNK, f"{len(content)} content events, {len(last)} batches"
        assert content[-1][1] - content[0][1] > 0.01, f"the stream came as one blob: {content}"
        chat_launches, chat_variants, _ = counts()
        assert engine.stats["completed"] == 3 and all(n > 0 for n in chat_launches.values()), (engine.stats, chat_launches)
        assert not any(contained(engine).values()), f"the scheduler caught and served on after {contained(engine)}"
        assert all(v == {"mma": chat_launches[n], "fma": 0} for n, v in chat_variants.items()), chat_variants
        assert not engine.active.any() and not engine.held
        log(f"  endpoint on port {server.port}: text chat {t_text:.3f} s, image chat {t_image:.3f} s, SSE stream {t_sse:.3f} s "
            f"in {len(chunks)} events, {len(content)} of them with content, arriving "
            f"{[round(at, 3) for _, at in content]} s after the request (24 new tokens each), over-long prompt refused "
            f"with HTTP 400; launches {chat_launches}; {engine.latency_percentiles()}; captured decode chunks "
            f"{graph_line(engine)} | {card}")
        # the data-generation pipeline's engine backend on the same running engine: prompts x G
        # requests through continuous batching, sampled at its default temperature
        done = engine.stats["completed"]
        t0 = time.time()
        records = generate_records(DATAGEN_PROMPTS, engine=engine, processor=legible, num_generations=2,
                                   max_new_tokens=32, timeout=SERVE_WAIT_S)
        t_gen = time.time() - t0
        assert [r["instruction"] for r in records] == DATAGEN_PROMPTS, records
        assert all(len(r["generations"]) == 2 and all(isinstance(g, str) for g in r["generations"]) for r in records)
        assert engine.stats["completed"] == done + 2 * len(DATAGEN_PROMPTS), engine.stats
        assert not any(contained(engine).values()), f"the scheduler caught and served on after {contained(engine)}"
        log(f"  generate_records(engine=...): {len(DATAGEN_PROMPTS)} prompts x 2 generations of up to 32 tokens in "
            f"{t_gen:.3f} s; generation lengths {[[len(g) for g in r['generations']] for r in records]} | {card}")
    finally:
        server.stop()
        undo()
    checks = held_on_pool(engine, seen, "on the endpoint's pool")
    del engine, server

    def served(cache_dtype):
        """The episodes on a fresh engine with its pump running, held to held_to and logged: (the
        requests' tokens, launches, int8 launches)."""
        reset()
        engine = engine_for(env.params, cache_dtype)
        seen = {"k1": {}, "k2": {}, "k3": {}}
        undo = watch(engine, seen)
        engine.start()
        try:
            wall, res, tokens = episodes(engine)
        finally:
            engine.stop()
            undo()
        launches, variants, int8 = counts()
        peak = torch.cuda.max_memory_allocated()
        held_to(engine, res, tokens, launches, variants)
        st, lat = engine.stats, sorted(r.latency_s for r in res)
        pools = [sum(t.numel() * t.element_size() for t in c.k + c.v + ((c.kscale + c.vscale) if c.quantized else []))
                 for c in (engine.cache, engine._ppool)]
        log(f"  run_episodes_served, {str(engine.cache_dtype).split('.')[1]} cache: {SERVE_EPISODES} episodes over "
            f"{SERVE_SLOTS} slots in {wall:.3f} s ({SERVE_EPISODES / wall:.3f} episodes/s); episode latency p50 "
            f"{lat[len(lat) // 2]:.3f} s, max {lat[-1]:.3f} s; per request {engine.latency_percentiles()} | {card}")
        log(f"    engine stats {dict(st)}; live share of stepped rows "
            f"{st['decode_live_row_steps'] / st['decode_device_row_steps']:.3f} | {card}")
        log(f"    engine phases (host seconds, device waits included) {engine.stats_timing()} | {card}")
        log(f"    captured decode chunks: {graph_line(engine)}; compact staging rows "
            f"{engine.staging_bytes() / 2**30:.3f} GiB | {card}")
        log(f"    launches {launches}, of them on int8 K/V {int8}; K1/K2 by variant {variants}; peak memory "
            f"{peak / 2**30:.3f} GiB (slot pool {pools[0] / 2**30:.3f} GiB, prefix pool {pools[1] / 2**30:.3f} GiB; weights "
            f"and earlier phases' leftovers included) | {card}")
        for n, held in held_on_pool(engine, seen, "on the episodes' pool").items():
            checks[n].extend(held)
        return tokens, launches, int8

    # (2) episodes on a running engine, bf16 cache
    tokens, launches, int8_bf16 = served(None)
    assert int8_bf16 == dict.fromkeys(names[1:], 0), f"int8 entries taken with a bf16 cache: {int8_bf16}"

    # (3) the same episodes on an int8 KV cache
    tokens8, launches8, int8 = served(torch.int8)
    assert int8 == {n: launches8[n] for n in names[1:]}, (int8, launches8)
    same = sum(p == q for rid in tokens for p, q in zip(tokens[rid], tokens8[rid]))
    total = sum(len(t) for t in tokens.values())
    log(f"  tokens of the int8 cache's run identical to the bf16 cache's: {same} of {total} ({same / total:.4f}) | {card}")
    # wrong scales would give finite, wrong tokens; batching differs between the runs (it follows the
    # host's timing), and a greedy row that departs once stays apart, so this is no exact bar
    assert same >= 0.9 * total, f"int8 cache: only {same} of {total} tokens equal the bf16 cache's"

    # (4) the engine's decode step, eagerly and captured, in turns: full-width chunks (8 live rows) and
    # compact ones (4 live rows: row bucket 4), on the bf16 and on the int8 KV cache; then captured
    # over bf16 weights and over the int8 weight layout, in turns
    qparams = quantize_decoder_int8(env.params)
    rng_ids = [[cfg.tokens.im_start] + [40 + (7 * r + j) % 200 for j in range(100 + r)] for r in range(SERVE_SLOTS)]

    def engine_steps(params, cache_dtype, live, captured):
        """(wall ms per decode step over 5 chunks, every row's tokens, the engine's graph stats, its
        staging bytes): `live` rows admitted, a first chunk (eager: its key's first) and a second
        (captured and replayed), then 5 chunks timed. captured=False runs the same chunk step eagerly."""
        e = engine_for(params, cache_dtype)
        if not captured:
            e.graphs.run = lambda key, fn, generators=(): fn()  # the chunk's step function, eagerly
        for r, ids in enumerate(rng_ids[:live]):
            e.submit(Request(request_id=f"d{r}", token_ids=ids, images=[], max_tokens=SERVE_CHUNK * 8))
        e.step()
        e.step()
        assert e.active.sum() == live and not any(contained(e).values()), contained(e)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            e.step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / (5 * SERVE_CHUNK)
        assert not any(contained(e).values()), contained(e)
        return ms, [list(s.generated) for s in e.slots[:live]], graph_line(e), e.staging_bytes()

    for kind, cache_dtype in (("bf16", None), ("int8", torch.int8)):
        for live, form in ((SERVE_SLOTS, "full-width"), (SERVE_SLOTS // 2, "compact")):
            times, toks = {"eager": [], "captured": []}, {}
            for mode in ("eager", "captured", "captured", "eager"):
                ms, toks[mode], stats, staging = engine_steps(env.params, cache_dtype, live, mode == "captured")
                times[mode].append(ms)
                if mode == "captured":
                    held = (stats, staging)
            assert toks["eager"] == toks["captured"], f"engine {form} chunk, {kind} cache: captured tokens differ"
            log(f"  engine decode step, {form} chunks of {SERVE_CHUNK}, {live} live rows of {SERVE_SLOTS}, {kind} KV "
                f"cache, attend 512, wall ms per step over 5 chunks (two runs each, in turns): eager {times['eager']}, "
                f"captured {times['captured']}; tokens identical; graphs {held[0]}, staging rows "
                f"{held[1] / 2**30:.3f} GiB | {card}")
    times = {"bf16": [], "int8": []}
    for label in ("bf16", "int8", "int8", "bf16"):
        times[label].append(engine_steps(env.params if label == "bf16" else qparams, None, SERVE_SLOTS, True)[0])
    log(f"  engine decode step, captured, {SERVE_SLOTS} live rows, attend 512, wall ms per step over 5 chunks of "
        f"{SERVE_CHUNK} (both runs each, in turns): bf16 weights {times['bf16']}, int8 layout through qdot (weights "
        f"widened per product) {times['int8']}; trees {quantized_bytes(env.params) / 2**30:.3f} and "
        f"{quantized_bytes(qparams) / 2**30:.3f} GiB | {card}")
    # one decoder matmul at the decode step's shape, on the device: what a W8A16 kernel has to beat
    w, qw = env.params["text"]["layers"][0]["mlp"]["wg"], qparams["text"]["layers"][0]["mlp"]["wg"]
    x = torch.randn((SERVE_SLOTS, 1, w.shape[0]), device="cuda", generator=torch.Generator(device="cuda").manual_seed(2)
                    ).to(w.dtype)
    with torch.inference_mode():
        ref = x @ (qw["q"].float() * qw["s"].float()).to(w.dtype)
        err = max_err(qdot(x, qw), ref)
        ms, dev = time_in_turns([lambda: x @ w, lambda: qdot(x, qw)])
    # three bf16 roundings apart (qdot's product and its scale multiply; the reference's dequantized
    # weight), each 2^-8 of the largest output
    tol = 3 * 2.0 ** -8 * max(1.0, ref.abs().max().item())
    assert err <= tol, (err, tol)
    log(f"  one MLP gate product at the decode shape ({SERVE_SLOTS} x {w.shape[0]} @ {w.shape[0]} x {w.shape[1]}), "
        f"L2 cold, in turns: bf16 torch.mm {ms[0]:.4f} ms per call, {dev[0]:.4f} ms device; qdot over int8 (widen, "
        f"product, scale) {ms[1]:.4f} ms per call, {dev[1]:.4f} ms device; the int8 weight's bytes at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s {1e3 * qw['q'].numel() / PEAK_BYTES:.4f} ms, the bf16 weight's "
        f"{2e3 * w.numel() / PEAK_BYTES:.4f} ms; qdot vs its dequantized product max_abs_err {err:.3e} (tol {tol:.3e}) | {card}")
    del qparams, qw
    out = {n: {"launches_serving": chat_launches[n] + launches[n]} for n in names}
    for n in names[1:]:
        out[n]["launches_serving_int8"] = int8[n]
    return out, checks


def cache_bytes(generator, batch):
    """Bytes of one KV cache of `batch` rows in the generator's layout (scales included)."""
    t = generator.cfg.text
    slots = 2 * t.num_hidden_layers * batch * t.num_key_value_heads * generator.max_cache_len
    item = torch_itemsize(generator.cache_dtype)
    return slots * t.head_dim * item + (slots * 4 if item == 1 else 0)


def eager_and_captured(label, card, make_step, steps):
    """A decode path's step at its own shapes, eagerly and captured (runtime.graphs): make_step()
    gives (state, step, rng) over a fresh copy of the path's decode inputs (a Generator's
    solo_step or pair_step). `steps` eager steps, timed; then, on a second copy, one eager step,
    the capture and steps - 1 replays, the last steps - 2 of them timed. Both token buffers must be
    equal. Returns {"eager_ms": per step, "captured_ms": per replayed step, "capture_ms"}."""
    import torch

    from zoomearth_tpu_torch.runtime.graphs import StepGraphs

    with torch.inference_mode():  # a Generator's caches are inference tensors
        st, step, _ = make_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        eager_ms = 1e3 * (time.perf_counter() - t0) / steps
        eager_tokens = st.tokens.clone()
        del st, step
        st, step, rng = make_step()
        graphs = StepGraphs("cuda")
        gens = (rng,) if rng is not None else ()
        graphs.run("step", step, gens)  # eager
        graphs.run("step", step, gens)  # captured, then replayed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps - 2):
            graphs.run("step", step, gens)
        torch.cuda.synchronize()
        captured_ms = 1e3 * (time.perf_counter() - t0) / (steps - 2)
        same = torch.equal(st.tokens, eager_tokens)
    B = st.tokens.shape[0]
    log(f"  decode step, {label}, {B} rows: eager {eager_ms:.3f} ms, captured {captured_ms:.3f} ms per step "
        f"({eager_ms / captured_ms:.2f}x), capture {1e3 * graphs.capture_s:.1f} ms; tokens of {steps} steps "
        f"identical: {same} | {card}")
    assert same, f"{label}: the captured steps' tokens differ from the eager steps'"
    return {"eager_ms": eager_ms, "captured_ms": captured_ms, "capture_ms": 1e3 * graphs.capture_s}


def graph_line(owner, before=(0, 0.0)):
    """One line of a Generator's or an engine's captured decode (`owner.graphs`): graphs
    captured since `before` (graph_counts' earlier reading), their capture seconds, graphs
    that replay now."""
    n, secs = owner.graphs.captures - before[0], owner.graphs.capture_s - before[1]
    return f"{n} graphs captured in {secs:.3f} s ({1e3 * secs / max(n, 1):.1f} ms each), {owner.graphs.held} held"


def graph_counts(owner):
    return owner.graphs.captures, owner.graphs.capture_s


def torch_itemsize(dtype):
    import torch

    return torch.empty((), dtype=dtype).element_size()


def check_k4_edges():
    """K4 against its plain version and against K3 on the same k/v, untimed, where the
    split pass meets pages: pages of 16 (a 32-slot tile crosses them), 64 and 256; rows
    of length 0 (K4 gives 0 and reads nothing), 1, either side of a split and of a page
    boundary, capacity and past it; block-table entries past each row's pages set to
    ids far outside the pool (a read of one would fault); bf16 D=128 (tol 2e-2) and
    fp32 D=32 (tol 1e-4: fp32 sums in another order). Returns the checks."""
    import numpy as np
    import torch

    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.ops import paged_attention as K4
    from zoomearth_tpu_torch.scripts import paged_256_test as PT

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, Hkv = 8, 16, 2
    checks = []
    for page in (16, 64, 256):
        for dtype, D, tol in ((torch.bfloat16, 128, TOL_BF16), (torch.float32, 32, 1e-4)):
            T = max(4 * page, 256)
            split = K3.split_plan(B, Hkv, T)[0]
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((B, H, D), (B, Hkv, T, D), (B, Hkv, T, D)))
            kpool, vpool, bt = PT.to_pages(k, v, page, np.random.default_rng(6))
            lens = torch.tensor([0, 1, split - 1, split + 1, page - 1, page + 1, T, T + 9], device=dev)
            tail = torch.arange(T // page, device=dev)[None] >= K4.page_counts(lens.clamp(max=T), page)[:, None]
            bt = torch.where(tail, torch.full_like(bt, 2**30), bt)
            out = K4.paged_decode_cuda(q, kpool, vpool, bt, lens, page_size=page)
            label = f"K4 page {page} {str(dtype).split('.')[1]} D={D} T={T} (split {split}), lengths {lens.tolist()}"
            checks.append(edge_check(label, out, K4.paged_decode_attention_plain(q, kpool, vpool, bt, lens,
                                                                                 page_size=page), tol))
            checks.append(edge_check(label + " vs K3 on the same k/v, rows with a live slot", out[1:],
                                     K3.decode_attention_cuda(q, k, v, lens)[1:], tol))
            if bool(out[0].any()):
                raise AssertionError(f"{label}: a row with no live slot must give 0")
    return checks


def check_p1_edges():
    """P1 against its plain version, untimed, where its tiling has edges: row blocks of
    4, 2 and 1 rows, chunks of 512 and chunks under 64 (the first 64 flattened rows
    then span several kv heads and rows), row blocks that are no whole number of
    tiles, bf16 and fp32. out to one step of its dtype (fp32 sums in another order,
    one rounding), sums to 1e-6 of the summed magnitudes (atomics in any order).
    Returns the checks."""
    import torch

    from zoomearth_tpu_torch.scripts import probe_attn as PA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    checks = []
    for B, H, Hkv, D, T, chunk, rb in ((8, 16, 2, 128, 1536, 512, 4), (6, 16, 2, 128, 1024, 512, 2),
                                       (3, 16, 2, 64, 1536, 512, 1), (4, 8, 2, 32, 96, 16, 2),
                                       (4, 4, 1, 16, 200, 40, 4), (5, 16, 2, 64, 96, 8, 1)):
        for dtype, step in ((torch.bfloat16, 2.0**-7), (torch.float32, 1e-6)):
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((B, 1, H, D), (B, Hkv, T, D), (B, Hkv, T, D)))
            (out, sums), (ref, ref_sums) = (fn(q, k, v, chunk=chunk, rb=rb)
                                            for fn in (PA.stream_only_cuda, PA.stream_only_plain))
            torch.cuda.synchronize()
            step_ok = bool(((out.float() - ref.float()).abs() <= step * ref.float().abs() + 1e-5).all())
            mass = (k.double().abs() + v.double().abs()).reshape(B // rb, -1).sum(1)
            sum_err = ((sums.double() - ref_sums.double()).abs() / mass).max().item()
            label = f"P1 B={B} H={H} Hkv={Hkv} D={D} T={T} chunk {chunk} rb {rb} {str(dtype).split('.')[1]}"
            log(f"  {label}: out max_abs_err {max_err(out, ref):.3e} (tol one step, {step:.1e} of the value), sums "
                f"{sum_err:.3e} of the summed magnitudes (tol 1e-6), untimed")
            if not (step_ok and sum_err <= 1e-6):
                raise AssertionError(f"{label}: P1 disagrees with its plain version")
            checks.append({"case": label, "max_abs_err": max_err(out, ref), "sum_err_over_mass": sum_err,
                           "tol": f"{step:.1e} of the value; sum 1e-6 of the summed magnitudes"})
    return checks


def cell_label(B, T, live):
    return f"B={B} T={T} {int(live * 100)}% live"


def check_decode_variants():
    """K4, P1 and P2 against their plain versions, K4 also against K3 and P2 against
    fp32 decode attention, on the entry points' own inputs. Returns {kernel name:
    {case: checks}}, the cases named as the entry points name them."""
    import numpy as np
    import torch

    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.ops import paged_attention as K4
    from zoomearth_tpu_torch.scripts import paged_256_test as PT
    from zoomearth_tpu_torch.scripts import probe_attn as PA

    err = max_err
    dev = torch.device("cuda")
    checks = {"paged_decode_attention": {}, "stream_only": {}, "bigmm_decode_attention": {}}
    for B, T, live in PT.CELLS:
        rng = np.random.default_rng(PT.SEED)  # as measure_cell draws them
        q, k, v, lens = PT.cell_inputs(rng, B, T, live, dev)
        k3 = K3.decode_attention_cuda(q, k, v, lens)[:, 0]
        for page in PT.PAGES:
            kpool, vpool, bt = PT.to_pages(k, v, page, rng)
            out = K4.paged_decode_cuda(q[:, 0], kpool, vpool, bt, lens, page_size=page)
            ref = K4.paged_decode_attention_plain(q[:, 0], kpool, vpool, bt, lens, page_size=page)
            c = {"max_abs_err": err(out, ref), "max_abs_err_vs_k3": err(out, k3), "tol": TOL_BF16}
            log(f"  {cell_label(B, T, live)} K4 paged[{page}]: vs its plain version {c['max_abs_err']:.3e}, vs K3 "
                f"on the same k/v {c['max_abs_err_vs_k3']:.3e} (tol {TOL_BF16})")
            assert max(c["max_abs_err"], c["max_abs_err_vs_k3"]) <= TOL_BF16, "K4 disagrees"
            assert bool(torch.isfinite(out.float()).all()), "K4 gave non-finite values"
            checks["paged_decode_attention"][f"{cell_label(B, T, live)} K4 paged[{page}]"] = c
        del k, v, kpool, vpool

    q, k, v, lens = PA.probe_inputs(dev)
    full = torch.full_like(lens, k.shape[2])
    (o, s), (r, rs) = PA.stream_only_cuda(q, k, v, full), PA.stream_only_plain(q, k, v, full)
    # fp32 sums in another order, then one bf16 rounding: one bf16 step (2^-7 of the
    # value) apart at most; the element sum to 1e-6 of the summed magnitudes
    step_ok = bool(((o.float() - r.float()).abs() <= 2.0**-7 * r.float().abs() + 1e-5).all())
    mass = (k.double().abs() + v.double().abs()).reshape(rs.shape[0], -1).sum(1)
    sum_err = ((s.double() - rs.double()).abs() / mass).max().item()
    checks["stream_only"]["P1 stream_only (copy floor) len=T"] = {
        "max_abs_err": err(o, r), "sum_err_over_mass": sum_err,
        "tol": "2^-7 of the value; sum 1e-6 of the summed magnitudes"}
    log(f"  P1: out vs its plain version {err(o, r):.3e} (tol one bf16 step, 2^-7 of the value), sum {sum_err:.3e} "
        f"of the summed magnitudes (tol 1e-6)")
    assert step_ok and sum_err <= 1e-6, "P1 disagrees with its plain version"
    for label, ln in (("len600-1200", lens), ("len=T", full)):
        out = PA.bigmm_decode_cuda(q, k, v, ln, chunk=PA.CHUNK)
        c = {"max_abs_err": err(out, PA.bigmm_decode_attention_plain(q, k, v, ln, chunk=PA.CHUNK)),
             "max_abs_err_vs_decode_attention": err(out, K3.flash_decode_attention_plain(q, k, v, ln)),
             "tol": TOL_BF16}
        log(f"  P2 {label}: vs its plain version {c['max_abs_err']:.3e}, vs fp32 decode attention "
            f"{c['max_abs_err_vs_decode_attention']:.3e} (tol {TOL_BF16})")
        assert max(c["max_abs_err"], c["max_abs_err_vs_decode_attention"]) <= TOL_BF16, "P2 disagrees"
        assert bool(torch.isfinite(out.float()).all()), "P2 gave non-finite values"
        checks["bigmm_decode_attention"][f"P2 bigmm512 {label}"] = c
    return checks


def run_decode_variants(card, checks):
    """The decode-attention entry points as a user runs them (probe_attn.measure,
    paged_256_test.measure_cell at both cells) and a paged decode loop, with the
    launch counts set to 0 just before and read just after. Their in-turns times of
    K4, P1 and P2 beside their plain versions, with `checks`, make the kernels-line
    rows; returns (rows as check_kernels returns them, launches by kernel name)."""
    import numpy as np
    import torch

    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.ops import paged_attention as K4
    from zoomearth_tpu_torch.scripts import paged_256_test as PT
    from zoomearth_tpu_torch.scripts import probe_attn as PA
    from zoomearth_tpu_torch.scripts.timing import PLAIN

    wrappers = {"paged_decode_attention": K4.paged_decode_cuda, "stream_only": PA.stream_only_cuda,
                "bigmm_decode_attention": PA.bigmm_decode_cuda}
    for w in wrappers.values():
        w.launches = 0
    q, k, v, lens = PA.probe_inputs(torch.device("cuda"))
    B, H, Hkv, D, T = PA.SHAPE
    full = torch.full_like(lens, T)
    slot = torch.arange(T, device=lens.device)
    work = {"P1 stream_only (copy floor) len=T": PA.stream_work(q, k)}
    library = []  # P2's yardstick: one SDPA call with a length mask, timed in the entry point's own turns
    for label, ln in (("len600-1200", lens), ("len=T", full)):
        mask = (slot[None] < ln[:, None])[:, None, None]
        fn = lambda mask=mask: sdpa(q.transpose(1, 2), k, v, mask).transpose(1, 2)  # noqa: E731
        lib_err = max_err(fn(), K3.flash_decode_attention_plain(q, k, v, ln))
        log(f"  P2 bigmm512 {label}: library call vs fp32 decode attention max_abs_err {lib_err:.3e} (tol {TOL_BF16}); "
            f"SDPA backends that take it: {sdpa_backends(fn)}")
        assert lib_err <= TOL_BF16, "P2's library yardstick disagrees with decode attention"
        library.append((f"P2 bigmm512 {label}{LIBRARY}", fn, None))
        work[f"P2 bigmm512 {label}"] = PA.bigmm_work(ln, T, H, Hkv, D)
    times = PA.measure(q, k, v, lens, library)
    del q, k, v, library, fn, mask  # the probe's tensors, before the paged cells allocate theirs
    for name, (ms, dev, gbs) in times.items():
        rate = f", {gbs:.1f} GB/s of cache {'walked' if name.startswith('P2') else 'read'}" if gbs else ""
        log(f"  probe_attn {name}: {ms:.4f} ms/call, {ms * PA.LAYERS:.2f} ms/{PA.LAYERS}-layer | device "
            f"{dev:.4f} ms/call, {dev * PA.LAYERS:.2f} ms/{PA.LAYERS}-layer{rate} | L2 cold | {card}")
    for B, T, live in PT.CELLS:
        cell_lens = torch.from_numpy(PT.cell_lengths(np.random.default_rng(PT.SEED), B, T, live))  # measure_cell's
        for page in PT.PAGES:
            work[f"{cell_label(B, T, live)} K4 paged[{page}]"] = K4.work(
                cell_lens, torch.empty((B, T // page), dtype=torch.int32), page, PT.H, PT.HKV, PT.D, 2)
        cell, err = PT.measure_cell(B, T, live)
        log(f"  paged_256_test {cell_label(B, T, live)}: K4 vs K3 max_abs_err {err:.3e}")
        for name, (ms, dev, gbs) in cell.items():
            rate = f", {gbs:.1f} GB/s of live cache read" if gbs else ""
            log(f"    {name}: {ms * PT.LAYERS:.3f} ms/{PT.LAYERS}-layer step ({ms:.4f} ms/call) | device "
                f"{dev * PT.LAYERS:.3f} ms/{PT.LAYERS}-layer step ({dev:.4f} ms/call{rate}) | L2 cold | {card}")
            times[f"{cell_label(B, T, live)} {name}"] = (ms, dev, gbs)
    err, unchanged, same = PT.decode_loop(torch.device("cuda"))
    log(f"  paged decode loop: K4 vs K3 max_abs_err {err:.3e} (tol {TOL_BF16}); full row's pages unchanged: "
        f"{unchanged}; pools equal the contiguous cache on live slots: {same}")
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"  decode-variants launches (eager; graph replays run the kernels without the wrappers): {launches}")
    assert unchanged and same and err <= TOL_BF16, "paged decode loop failed"
    assert all(n > 0 for n in launches.values()), f"decode-variant kernels not launched: {launches}"

    log("  each kernel case against its plain version, from the runs above:")
    sources = {"paged_decode_attention": ("zoomearth_tpu_torch/csrc/paged_decode.cu",
                                          "zoomearth_tpu/ops/paged_attention.py:95"),
               "stream_only": ("zoomearth_tpu_torch/csrc/probe_stream.cu", "scripts/probe_attn.py:43"),
               "bigmm_decode_attention": ("zoomearth_tpu_torch/csrc/probe_bigmm.cu", "scripts/probe_attn.py:124")}
    rows = {}
    for name, cases in checks.items():
        rows[name] = (*sources[name], [
            timing_row(label, check, times[label][:2], times[label + PLAIN][:2], card, work[label],
                       times[label + LIBRARY][:2] if label + LIBRARY in times else None, times[label][2])
            for label, check in cases.items()])
    gbs = rows["stream_only"][2][0]["gb_per_s_device"]
    if not gbs < 1000 * PA.HBM_TBPS:
        raise AssertionError(f"P1 reports {gbs:.1f} GB/s, above the card's {PA.HBM_TBPS} TB/s: its loads were removed")
    return rows, launches


INTERNVL_IMAGES, INTERNVL_ANYRES = 8, 8  # 8 images of 5000 px at 5 tiles each (4 + the thumbnail)
# 75 bytes: in the REC template under the byte-level FakeTokenizer, 5 tiles of 256 tokens make a
# 1805-token prompt (the 2048 bucket); the reference's max_anyres_num=12 gives 10 tiles and 3085 tokens
INTERNVL_QUESTION = "Which vessel is moored closest to the end of the long pier in the harbours?"


def frozen(t):
    """A copy of t with t's strides (a prefix view of a longer cache stays such a view), or
    a plain clone where t repeats elements (an expanded view)."""
    import torch

    if t is None:
        return None
    if 0 in t.stride():
        return t.clone()
    c = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device=t.device)
    c.copy_(t)
    return c


def check_tiny_internvl_parity():
    """The tiny InternVL config in fp32 on the card (K2's and K3's fp32 variants) against
    the CPU plain path, which tests/test_torch_internvl.py holds against the JAX package:
    InternViT's embeddings, the embeds-path prefill logits and the greedy tokens, over
    two images of different aspect (9 and 7 tiles of 28 px)."""
    import numpy as np
    import torch
    from PIL import Image

    from zoomearth_tpu_torch.config import InternVLVLMConfig
    from zoomearth_tpu_torch.models.internvit import init_internvl_params
    from zoomearth_tpu_torch.models.internvl import InternVLRunner, get_question_template
    from zoomearth_tpu_torch.models.params import map_tree
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig

    cfg = InternVLVLMConfig.tiny()
    rng = np.random.default_rng(0)
    images = [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for w, h in ((200, 100), (90, 150))]
    questions = [get_question_template().format(Question=q) for q in ("where is the ship?", "a road?")]
    params = init_internvl_params(cfg, torch.Generator().manual_seed(0))
    tok = legible_tokenizer(cfg.tokens)
    cpu = InternVLRunner(params, cfg, tok, max_cache_len=1024, device="cpu")
    gpu = InternVLRunner(map_tree(lambda t: t.cuda(), params), cfg, tok, max_cache_len=1024)
    (ec, counts), (eg, counts_g) = cpu.encode_images(images), gpu.encode_images(images)
    err_e = (ec - eg.cpu()).abs().max().item()
    bc, bg = cpu.prepare(questions, ec, counts), gpu.prepare(questions, eg, counts_g)
    lc = cpu.generator.run_prefill(bc, max_new=16)[0]
    lg = gpu.generator.run_prefill(bg, max_new=16)[0].cpu()
    err_l = (lc - lg).abs().max().item()
    gen = GenerationConfig(max_new_tokens=16, temperature=0.0)
    toks_c, toks_g = cpu.generator.generate(bc, gen), gpu.generator.generate(bg, gen)
    texts = gpu.generate(questions, images, gen)
    log(f"  tiny InternVL fp32, {counts} tiles, prompt bucket {bc.input_ids.shape[1]}: InternViT embeds max_abs_err "
        f"{err_e:.3e}, prefill logits {err_l:.3e} (tol 1e-4 each); greedy tokens "
        f"{'identical' if toks_c == toks_g else 'DIFFER'} ({sum(map(len, toks_g))} tokens)")
    if not (counts == counts_g == [9, 7] and err_e <= 1e-4 and err_l <= 1e-4 and toks_c == toks_g
            and all(texts) and texts == [tok.decode(t).strip() for t in toks_g]):
        raise AssertionError("tiny InternVL parity on the card failed")


def run_internvl(card):
    """InternVL at full width (the module docstring, phase 13). Returns ({kernel name:
    {"launches_internvl": n, "planted_faults_rejected": [...]}}, {kernel name: [timed
    cases at the path's forms]}, {kernel name: [untimed checks]})."""
    import gc

    import torch

    from zoomearth_tpu_torch.config import InternVLVLMConfig
    from zoomearth_tpu_torch.models import decoder as DEC
    from zoomearth_tpu_torch.models.internvit import init_internvl_params, internvit_embeds
    from zoomearth_tpu_torch.models.internvl import InternVLRunner, get_question_template
    from zoomearth_tpu_torch.models.params import param_count
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig
    from zoomearth_tpu_torch.utils.profiling import annotate, trace, tracer

    gc.collect()
    torch.cuda.empty_cache()
    check_tiny_internvl_parity()

    cfg = InternVLVLMConfig()
    L = cfg.text.num_hidden_layers
    t0 = time.time()
    params = init_internvl_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                                  dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  InternVLVLMConfig() random bf16 params: {param_count(params) / 1e9:.3f} B (vision "
        f"{param_count(params['vision']) / 1e9:.3f} B) in {time.time() - t0:.2f} s")
    tok = legible_tokenizer(cfg.tokens)
    runner = InternVLRunner(params, cfg, tok, max_anyres_num=INTERNVL_ANYRES)
    images = [synthetic_tile(100 + i) for i in range(INTERNVL_IMAGES)]
    question = get_question_template().format(Question=INTERNVL_QUESTION)
    questions = [question] * INTERNVL_IMAGES
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, temperature=0.0)
    names = ("flash_segment_attention", "flash_causal_attention", "flash_decode_attention")
    kernels = (K1.segment_attention_cuda, K2.causal_attention_cuda, K3.decode_attention_cuda)

    # the main path, as a user runs it, with the decoder's two kernel dispatchers shadowed to keep a
    # copy of the inputs of the first call of each form (shapes and strides): what K2 and K3 are
    # held against their plain versions at afterwards
    forms = {"k2": {}, "k3": {}}
    causal, decode = DEC.flash_causal_attention, DEC.flash_decode_attention

    def keep(store, args):
        if torch.cuda.is_current_stream_capturing():
            return  # a copy made during capture would hold data that no kernel has written yet
        q, k = args[0], args[1]
        key = (tuple(q.shape), tuple(k.shape), k.stride(), str(k.dtype))
        if key not in store:
            store[key] = tuple(frozen(a) for a in args)

    def causal_kept(*args):
        keep(forms["k2"], args)
        return causal(*args)

    def decode_kept(*args):
        keep(forms["k3"], args)
        return decode(*args)

    for k in kernels:
        k.launches = 0
    for k in kernels[:2]:
        k.variants = dict.fromkeys(k.variants, 0)
    DEC.flash_causal_attention, DEC.flash_decode_attention = causal_kept, decode_kept
    graphs0 = graph_counts(runner.generator)
    try:
        t0 = time.time()
        texts = runner.generate(questions, images, gen)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        DEC.flash_causal_attention, DEC.flash_decode_attention = causal, decode
    launches = {n: k.launches for n, k in zip(names, kernels)}
    variants = dict(K2.causal_attention_cuda.variants)
    assert len(texts) == INTERNVL_IMAGES and all(texts), f"a row returned no tokens: {texts}"
    assert launches[names[0]] == 0, f"K1 ran on the InternVL path: {launches}"
    assert launches[names[1]] == L and variants == {"mma": L, "fma": 0}, (launches, variants)
    assert launches[names[2]] > 0 and launches[names[2]] % L == 0, launches
    log(f"  runner.generate over {INTERNVL_IMAGES} x 5000 px (max_anyres_num {INTERNVL_ANYRES}), greedy, "
        f"{NEW_TOKENS} new tokens: {wall:.3f} s cold | {card}")
    log(f"  launches {launches} (K2 {launches[names[1]] // L} prefill x {L} layers, all {variants}; K3 "
        f"{launches[names[2]] // L} decode steps x {L} layers); answer lengths {[len(t) for t in texts]}; "
        f"captured decode: {graph_line(runner.generator, graphs0)}")

    # the stages again, warm, through the tracer: the tiling on the host clock, InternViT on the
    # device (CUDA events, no synchronization between the stages), the prefill and the decode
    # call as the Generator's own device spans
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tracer.start()
    with tracer.span("anyres_tiles"):
        patches, counts = runner.tile_images(images)
    with tracer.span("internvit", device=True), torch.inference_mode():
        embeds = internvit_embeds(params["vision"], cfg.vision, torch.as_tensor(patches, device="cuda"))
    vit_peak = torch.cuda.max_memory_allocated()
    batch = runner.prepare(questions, embeds, counts)
    logits, cache, attend = runner.generator.run_prefill(batch, max_new=NEW_TOKENS)
    before = K3.decode_attention_cuda.launches
    tokens, cache = runner.generator.run_decode(logits, cache, batch.next_pos, gen, attend=attend)
    steps = (K3.decode_attention_cuda.launches - before) // L
    peak = torch.cuda.max_memory_allocated()
    tracer.stop()
    s = {n: sum(b - a for m, a, b, _ in tracer.spans if m == n) for n in ("anyres_tiles",)}
    s.update({n: sum(b - a for m, a, b in tracer.device if m == n) for n in ("internvit", "prefill", "decode")})
    assert all(s.values()), f"a stage was not traced: {s}"
    logits2, cache2, _ = runner.generator.run_prefill(batch, max_new=NEW_TOKENS)
    eager_and_captured(f"InternVL (run_decode), bf16 cache, attend {attend}", card, lambda: runner.generator.solo_step(
        logits2, cache2.clone(), batch.next_pos, gen, attend=attend), NEW_TOKENS)
    del logits2, cache2
    B, S = batch.input_ids.shape
    n_tiles = sum(counts)
    assert counts == [5] * INTERNVL_IMAGES and embeds.shape == (n_tiles * cfg.vision.num_image_token,
                                                                cfg.text.hidden_size), (counts, embeds.shape)
    assert int(batch.lengths.max()) <= 2048 and S == 2048, (batch.lengths, S)
    assert logits.shape == (B, cfg.text.vocab_size) and bool(torch.isfinite(logits).all()), "non-finite logits"
    log(f"  prompt lengths {sorted(set(batch.lengths.tolist()))} tokens ({n_tiles} tiles, "
        f"{embeds.shape[0]} image tokens) in the {S} bucket; attend span {attend}")
    log(f"  stages (warm; the tiles on the host clock, the rest device time from CUDA events): anyres tiles "
        f"{s['anyres_tiles']:.4f} s; InternViT over {n_tiles} tiles {s['internvit']:.4f} s; prefill B={B} S={S} "
        f"{s['prefill']:.4f} s; decode {steps} steps {s['decode']:.4f} s = {1e3 * s['decode'] / max(steps, 1):.2f} "
        f"ms/step | {card}")
    log(f"  peak memory {peak / 2**30:.3f} GiB ({vit_peak / 2**30:.3f} GiB during InternViT; {base / 2**30:.3f} GiB "
        f"allocated before, the weights {2 * param_count(params) / 2**30:.3f} GiB of it) | {card}")

    # one trace of a warm prefill: the profiler's events and the tracer's, the Generator's prefill span on
    # the device track among them
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        with trace(tdir):
            with annotate("internvl_prefill"):
                runner.generator.run_prefill(batch, max_new=NEW_TOKENS)
            torch.cuda.synchronize()
        files = os.listdir(tdir)
        assert len(files) == 1 and os.path.getsize(os.path.join(tdir, files[0])) > 0, files
        events = json.load(open(os.path.join(tdir, files[0])))["traceEvents"]
    dev_events = [e for e in events if e.get("cat") == "kernel"]
    assert any(e.get("name") == "internvl_prefill" for e in events), "the annotated region is not in the trace"
    assert dev_events, "the trace holds no device kernel"
    traced = [e for e in events if e.get("cat") == "tracer" and e.get("name") == "prefill"]
    assert len(traced) == 2, f"the prefill's host and device spans are not in the trace: {traced}"
    by_name = {}
    for e in dev_events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    log(f"  trace of a warm prefill ({files[0]}): the tracer's prefill span {[round(e['dur'] / 1e3, 4) for e in traced]}"
        f" ms (host, device); {len(dev_events)} device kernels from the profiler, {sum(by_name.values()) / 1e3:.3f} ms "
        f"of device kernel time; largest: {[(n[:60], round(d / 1e3, 4)) for n, d in top]} (ms) | {card}")
    del logits, cache, tokens, embeds, batch, runner, params
    gc.collect()
    torch.cuda.empty_cache()

    # K2 and K3 against their plain versions at exactly the forms this phase called them, then timed there
    assert len(forms["k2"]) == 1 and len(forms["k3"]) == 1, {k: list(v) for k, v in forms.items()}
    t = cfg.text
    H, Hkv, D = t.num_attention_heads, t.num_key_value_heads, t.head_dim
    checks, rows, planted = ({names[1]: [], names[2]: []}, {names[1]: [], names[2]: []},
                             {names[1]: [], names[2]: []})
    with torch.inference_mode():
        (q, k, v, pos, kvl, *_), = forms["k2"].values()
        T = k.shape[2]
        label = f"K2 InternVL embeds prefill B={q.shape[0]} S={q.shape[1]} T={T}, layer 0's inputs"
        checks[names[1]].append(held_on_path(label, K2.causal_attention_cuda(q, k, v, pos, kvl),
                                             K2.flash_causal_attention_plain(q, k, v, pos, kvl)))
        slot = torch.arange(T, device="cuda")
        mask = ((slot[None, None] <= pos[:, :, None]) & (slot[None, None] < kvl[:, None, None]))[:, None]
        rows[names[1]].append(case(label + ", timed", lambda: K2.causal_attention_cuda(q, k, v, pos, kvl),
                                   lambda: K2.flash_causal_attention_plain(q, k, v, pos, kvl), card,
                                   K2.work(pos, kvl, H, Hkv, D, T, 2),
                                   lambda: sdpa(q.transpose(1, 2), k, v, mask).transpose(1, 2), rows=True,
                                   library_tol=lambda ref: max(TOL_BF16, 2.0**-7 * ref.abs().max().item())))
        # the planted faults: every row's last 64 keys dropped (the kernel run on positions 64 lower)
        keys = torch.minimum(pos + 1, kvl[:, None].to(pos.dtype))
        long_rows = (keys >= 1024)[:, :, None]
        dropped = K2.causal_attention_cuda(q, k, v, (pos - 64).clamp(min=0), kvl)
        planted[names[1]].append(planted_fault(f"K2 with each row's last 64 keys dropped, {label}", dropped,
                                               K2.flash_causal_attention_plain(q, k, v, pos, kvl), long_rows))
        del q, k, v, pos, kvl, mask, keys, long_rows, dropped
        (q1, kd, vd, kvl3, *_), = forms["k3"].values()
        Td = kd.shape[2]
        label = (f"K3 InternVL decode B={q1.shape[0]}, attend {Td} view (strides {kd.stride()}), layer 0 at step 0, "
                 f"kv_len {sorted(set(kvl3.tolist()))}")
        checks[names[2]].append(held_on_path(label, K3.decode_attention_cuda(q1, kd, vd, kvl3),
                                             K3.flash_decode_attention_plain(q1, kd, vd, kvl3)))
        m3 = (torch.arange(Td, device="cuda")[None] < kvl3[:, None])[:, None, None]
        rows[names[2]].append(case(label + ", timed", lambda: K3.decode_attention_cuda(q1, kd, vd, kvl3),
                                   lambda: K3.flash_decode_attention_plain(q1, kd, vd, kvl3), card,
                                   K3.work(kvl3, Td, H, Hkv, D, 2),
                                   lambda: sdpa(q1.transpose(1, 2), kd, vd, m3).transpose(1, 2),
                                   K3.read_bytes(kvl3, Td, Hkv, D, 2), rows=True,
                                   library_tol=lambda ref: max(TOL_BF16, 2.0**-7 * ref.abs().max().item())))
        # the planted fault: the last 64 keys of the span dropped, as a split lost at the merge would
        long_rows = (kvl3 >= 1024).reshape(-1, *[1] * (q1.dim() - 2))
        planted[names[2]].append(planted_fault(
            f"K3 fed kv_len - 64, {label}", K3.decode_attention_cuda(q1, kd, vd, kvl3 - 64),
            K3.flash_decode_attention_plain(q1, kd, vd, kvl3), long_rows))
    del forms
    return ({n: {"launches_internvl": launches[n], "planted_faults_rejected": planted[n]} for n in names[1:]},
            rows, checks)


def run_kimi(card):
    """[kimi] (module docstring, phase 14): Kimi-VL at its published widths cut in
    depth, through the pipelined evaluation path, with the launch counts zeroed just
    before the run and read from it. Returns ({kernel name: {"launches_kimi": n}},
    {kernel name: [untimed checks]})."""
    import dataclasses

    import torch

    from portbench.harness.weights import make_weights
    from zoomearth_tpu_torch.agent import episode as EP
    from zoomearth_tpu_torch.agent import prompts as PT
    from zoomearth_tpu_torch.agent.processor import Processor
    from zoomearth_tpu_torch.config import KimiVLConfig
    from zoomearth_tpu_torch.eval.infer import run_inference
    from zoomearth_tpu_torch.models import mla, moe
    from zoomearth_tpu_torch.models.kimi_vl import hf_leaves, params_from_hf
    from zoomearth_tpu_torch.ops import flash_attention as K1
    from zoomearth_tpu_torch.ops import flash_causal as K2
    from zoomearth_tpu_torch.ops import flash_decode as K3
    from zoomearth_tpu_torch.ops import flash_mla_decode as K5
    from zoomearth_tpu_torch.runtime.generate import GenerationConfig, Generator
    from zoomearth_tpu_torch.train.data import LRSGROSample

    full = KimiVLConfig()
    cfg = dataclasses.replace(full, text=dataclasses.replace(full.text, num_hidden_layers=KIMI_LAYERS),
                              vision=dataclasses.replace(full.vision, depth=KIMI_BLOCKS))
    L = cfg.text.num_hidden_layers
    t0 = time.time()
    params = params_from_hf(make_weights(hf_leaves(cfg), 0, torch.device("cuda"), torch.bfloat16), cfg)
    torch.cuda.synchronize()
    log(f"  weights drawn in {time.time() - t0:.1f} s; vocabulary {cfg.text.vocab_size}, "
        f"{cfg.text.n_routed_experts} routed experts of {cfg.text.moe_intermediate_size}, latent "
        f"{cfg.text.kv_lora_rank} + {cfg.text.qk_rope_head_dim}, MoonViT heads of {cfg.vision.head_dim}")
    generator = Generator(params, cfg, max_cache_len=2048)
    processor = Processor(legible_tokenizer(cfg.tokens), cfg)
    # the byte-level tokenizer's prompt: Kimi-VL's turn markers around the question and a cut instruction
    kimi_prompt = PT.kimi_stage1_prompt
    PT.kimi_stage1_prompt = lambda q: PT.KIMI_PREFIX + q + PT.INSTRUCTION_EVAL[:80] + PT.KIMI_ASSISTANT
    EP.extract_bboxes = lambda text, scale=1.0: [[2200, 2200, 2380, 2350]]  # random weights emit no bbox
    tiles = {f"tile{i}.png": synthetic_tile(100 + i) for i in range(4)}
    samples = [LRSGROSample(question_id=str(i), image_name=f"tile{i % 4}.png", category="object",
                            question=f"what is near the marked area {i}?", higher_level="perception",
                            ground_truth="ship", bbox=[2200, 2200, 2380, 2350], type="object")
               for i in range(PIPE_SAMPLES)]
    gen1 = GenerationConfig(max_new_tokens=NEW_TOKENS, temperature=0.0)
    gen2 = GenerationConfig(max_new_tokens=PIPE_NEW_TOKENS_2, temperature=0.0)
    kernels = {"flash_segment_attention": K1.segment_attention_cuda, "flash_causal_attention": K2.causal_attention_cuda,
               "flash_mla_decode": K5.mla_decode_cuda, "flash_decode_attention": K3.decode_attention_cuda,
               "grouped_mm": moe.grouped_mm}

    def refused(*a, **kw):
        raise AssertionError("a plain version was reached on the card")

    plains = [(K1, "flash_segment_attention_plain"), (K2, "flash_causal_attention_plain"),
              (K5, "flash_mla_decode_plain")]
    kept = [getattr(m, n) for m, n in plains]
    for m, n in plains:
        setattr(m, n, refused)
    # the inputs of the run's first K5 call (layer 0 at the first decode call's eager step), kept
    first, dispatch = [], mla.flash_mla_decode

    def shadow(q, cache, kv_len, scale, dv=K5.DV):
        if not first:
            first.append((q.clone(), cache.clone(), kv_len.clone(), scale))
        return dispatch(q, cache, kv_len, scale, dv)

    mla.flash_mla_decode = shadow
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            path = os.path.join(out_dir, "kimi.jsonl")
            for k in kernels.values():
                k.launches = 0
                if hasattr(k, "variants"):
                    k.variants = dict.fromkeys(k.variants, 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            graphs0, before = graph_counts(generator), dict(generator.decode_steps)
            t0 = time.time()
            run_inference(generator, processor, samples, path, batch_size=BATCH, gen=gen1, stage2_gen=gen2,
                          image_loader=lambda s: tiles[s.image_name], mode="pipelined")
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {n: k.launches for n, k in kernels.items()}
            variants = {n: dict(k.variants) for n, k in kernels.items() if hasattr(k, "variants")}
            steps = {k: generator.decode_steps[k] - before.get(k, 0) for k in ("pair", "solo")}
            peak = torch.cuda.max_memory_allocated()
            graphs = graph_line(generator, graphs0)
            records = [json.loads(line) for line in open(path)]
    finally:
        mla.flash_mla_decode = dispatch
        for (m, n), f in zip(plains, kept):
            setattr(m, n, f)
        PT.kimi_stage1_prompt = kimi_prompt
    # K5 against its plain version at the path's own first call: layer 0's absorbed queries over the stage-1 latents
    q, lat, kvl, scale = first[0]
    held = held_on_path(f"K5 at the [kimi] path's first call, layer 0, B={q.shape[0]}, attend {lat.shape[2]}, kv_len "
                        f"{sorted(set(kvl.tolist()))}", K5.mla_decode_cuda(q, lat, kvl, scale),
                        K5.flash_mla_decode_plain(q, lat, kvl, scale))
    assert len(records) == PIPE_SAMPLES and all(r["error"] is False and isinstance(r["stage2"], str)
                                                for r in records), "a Kimi-VL record is missing or failed"
    # K5 once per layer per solo step and twice per pair step (one a wave), captured replays counted; no K3
    assert launches["flash_mla_decode"] == L * (2 * steps["pair"] + steps["solo"]) > 0, (launches, steps)
    assert launches["flash_decode_attention"] == 0, launches
    # K1 once per MoonViT block a tower call; K2 once per layer a prefill or chunk call; all on the tensor cores
    assert launches["flash_segment_attention"] > 0 and launches["flash_segment_attention"] % KIMI_BLOCKS == 0
    assert launches["flash_causal_attention"] > 0 and launches["flash_causal_attention"] % L == 0
    assert all(v == {"mma": launches[n], "fma": 0} for n, v in variants.items()), variants
    # three grouped products per routed layer a forward: at least the decode steps' (one forward a pair step)
    assert launches["grouped_mm"] >= 3 * (L - 1) * (steps["pair"] + steps["solo"]) > 0, (launches, steps)
    log(f"  {len(records)} records in {wall:.2f} s; decode steps {steps}; {graphs} | {card}")
    log(f"  launches of the run: {launches}; K1/K2 by variant: {variants}; peak memory {peak / 2**30:.2f} GiB "
        f"| {card}")
    del generator, params, first
    return ({n: {"launches_kimi": launches[n]} for n in ("flash_segment_attention", "flash_causal_attention",
                                                          "flash_mla_decode")}, {"flash_mla_decode": [held]})


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from zoomearth_tpu_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = smi
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    log(smi)

    t0 = time.time()
    path = _cuda.build()
    _cuda.lib()
    log(f"[build] {path.name} in {time.time() - t0:.1f} s (nvcc sm_90a)")
    ptxas = open(str(path) + ".log").read() if os.path.exists(str(path) + ".log") else ""
    spills = [ln.strip() for ln in ptxas.splitlines()
              if "spill stores" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(f"  ptxas: {len(spills)} kernel instantiations with spills" + (f", e.g. {spills[0]}" if spills else ""))
    grads = next((a.split("=", 1)[1] for a in argv if a.startswith("--tensor-grads=")), None)
    if grads is not None:
        depths = [tuple(int(x) for x in d.split(",")) for d in [grads] + [a for a in argv if "," in a and "=" not in a]]
        log("[tensor-grads] one SFT micro-step's gradients, fp32 and bf16, one rank against (1, 1, 2), max |diff| / "
            "max |value| a leaf")
        run_tensor_grads(card, depths)
        return 0
    if "--profile-sft" in argv:
        log("[profile-sft] Qwen2.5-VL-3B bf16, one warm SFT micro-step by kernel")
        profile_training(card)
        return 0

    log("[kernels] bf16, main-path shapes, kernel vs plain version, timed in turns")
    rows, untimed = check_kernels(card)
    log("[parity] tiny config: fp32 card kernels vs CPU plain path, bf16 card kernels vs plain versions on the card, "
        "then one SFT micro-step's gradients")
    check_tiny_parity()
    check_tiny_grad_parity()
    check_tiny_grpo_parity()
    log("[slice] Qwen2.5-VL-3B bf16, run_inference + run_episodes(reuse_cache=True)")
    env = slice_setup()
    launches = run_slice(card, env)
    log("[pipelined] Qwen2.5-VL-3B bf16, run_inference(mode='pipelined') over 3 waves of 8, then the int8 KV cache")
    pipelined = run_pipelined(card, env)
    log(f"[split-prefill] Qwen2.5-VL-3B bf16, B={SPLIT_B} S={SPLIT_S} embeds rows, max_cache_len {SPLIT_T}: the "
        f"one-shot prefill against prefill_split_rows={SPLIT_R}, then right_size_cache over one stage-1 / stage-2 "
        f"episode batch")
    split = run_split_prefill(card, env)
    log(f"[serving] Qwen2.5-VL-3B bf16 behind the ServingEngine: the OpenAI endpoint over HTTP, run_episodes_served over "
        f"{SERVE_EPISODES} episodes on {SERVE_SLOTS} slots, the int8 KV cache, the decode step over int8 weights")
    serving, serving_checks = run_serving(card, env)
    for name, held in serving_checks.items():
        untimed[name] = untimed.get(name, []) + held
    del env
    import gc

    gc.collect()  # earlier phases' reference cycles (an engine and its server) would hold the 3B weights
    torch.cuda.empty_cache()
    log(f"[training] Qwen2.5-VL-3B bf16, train_sft: {TRAIN_MICRO} micro-steps of one sample ({TRAIN_ACCUM} to an "
        f"update), checkpoints, a resume from step {TRAIN_RESUME_AT}, the HF export")
    training, bwd_launches = run_training(card)
    launches.update(bwd_launches)
    log(f"[grpo] Qwen2.5-VL-3B bf16, GRPOTrainer with G = 4: two full fine-tune steps (cut, uncut), a LoRA step, a "
        f"LoRA step through a ServingEngine; budgets {GRPO_NEW_1} / {GRPO_NEW_2}")
    grpo = run_grpo(card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[parallel] the training paths over a mesh: (a) nccl, one rank, Qwen2.5-VL-3B at full depth; (b) gloo, two "
        f"ranks sharing cuda:0, {PAR_LAYERS} layers and {PAR_BLOCKS} ViT blocks at full width; (c) gloo, two tensor "
        f"ranks sharing cuda:0, {PAR_C_LAYERS} layers and {PAR_C_BLOCKS} ViT blocks; (d) gloo, four tensor ranks "
        f"sharing cuda:0, {PAR_C_LAYERS} layers and {PAR_C_BLOCKS} ViT blocks")
    parallel = run_parallel(card)
    log("[decode-variants] K4 / P1 / P2 checked at the reference's shapes and at their edges, then the entry "
        "points' runs")
    checks = check_decode_variants()
    untimed.update({"paged_decode_attention": check_k4_edges(), "stream_only": check_p1_edges()})
    variant_rows, variant_launches = run_decode_variants(card, checks)
    rows.update(variant_rows)
    launches.update(variant_launches)
    log(f"[internvl] InternVLVLMConfig() bf16 (InternViT-300M + Qwen2.5-3B widths), InternVLRunner over "
        f"{INTERNVL_IMAGES} x 5000 px at max_anyres_num {INTERNVL_ANYRES}, greedy, {NEW_TOKENS} new tokens; the tiny "
        f"InternVL config's fp32 parity on the card first")
    internvl, internvl_rows, internvl_checks = run_internvl(card)
    for name, cases in internvl_rows.items():
        rows[name][2].extend(cases)
    for name, held in internvl_checks.items():
        untimed[name] = untimed.get(name, []) + held
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[kimi] Kimi-VL at its published widths, {KIMI_LAYERS} decoder layers (one dense, the rest routed) and "
        f"{KIMI_BLOCKS} MoonViT blocks, random bf16 weights, run_inference(mode='pipelined') over {PIPE_SAMPLES} "
        f"samples in waves of {BATCH}; the plain versions of K1, K2 and K5 refused for the phase")
    kimi, kimi_checks = run_kimi(card)
    for name, held in kimi_checks.items():
        untimed[name] = untimed.get(name, []) + held

    kernels = []
    for name, (source, replaces, cases) in rows.items():
        checks = untimed.get(name, [])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            **({"note": NOTES.get(name, BWD_NOTE)} if replaces is None else {}),
            "launches": launches.get(name, 0), **pipelined.get(name, {}), **split.get(name, {}), **serving.get(name, {}),
            **training.get(name, {}),
            **grpo.get(name, {}), **parallel.get(name, {}), **internvl.get(name, {}), **kimi.get(name, {}),
            "max_abs_err": max(c["max_abs_err"] for c in cases + checks),
            **{key: cases[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                                              "library_device_ms", "share_of_bound")},
            "cases": cases,
            **({"untimed_checks": checks} if checks else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
