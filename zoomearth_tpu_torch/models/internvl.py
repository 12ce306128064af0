"""InternVL family glue: prompts, image-token expansion, embeds-input generation (port
of models/internvl.py).

Counterpart of the reference's InvernVLModule (vlm_modules/internvl_module.py:17-341):
conversation templating (prepare_prompt), `<image>` -> <img><IMG_CONTEXT>*N</img>
expansion (prepare_model_inputs :100-110), anyres tiling (dynamic_preprocess, in
image/anyres.py) and is_embeds_input generation: the InternViT tower runs once over
all of a batch's tiles on the device, and the decoder consumes the merged embeddings
through the Generator's embeds path (K2 for the prefill, K3 for every decode step).

The prompt helpers and prepare_internvl_batch are host code, held equal to the
reference's by tests/test_torch_internvl.py.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..cli.common import resolve_device
from ..config import InternVLVLMConfig
from ..image.anyres import load_image_anyres
from ..runtime.generate import (
    DEFAULT_LENGTH_BUCKETS,
    GenerationConfig,
    Generator,
    PreparedBatch,
    bucket,
)
from .internvit import internvit_embeds, patchify_tiles
from .params import tree_leaves

IMG_START_TOKEN = "<img>"
IMG_END_TOKEN = "</img>"
IMG_CONTEXT_TOKEN = "<IMG_CONTEXT>"

SYSTEM_MESSAGE = (
    "你是书生·万象, an AI assistant whose name is InternVL."
)


def chat_prompt(question: str, system_message: str = SYSTEM_MESSAGE, n_images: int = 1) -> str:
    """Qwen2-chat conversation template (InternVL3's conv_template rendered the way
    reference prepare_prompt does: system turn + user turn + empty assistant turn;
    each image becomes an '<image>\\n' marker, internvl_module.py:264-268)."""
    image_markers = "<image>\n" * n_images
    return (
        f"<|im_start|>system\n{system_message}<|im_end|>\n"
        f"<|im_start|>user\n{image_markers}{question}<|im_end|>\n"
        f"<|im_start|>assistant\n"
    )


def expand_image_tokens(text: str, tiles_per_image: Sequence[int], num_image_token: int) -> str:
    """Replace each `<image>` with <img> + <IMG_CONTEXT> * N_tile * tokens + </img>
    (reference prepare_model_inputs, internvl_module.py:100-110)."""
    for n_tiles in tiles_per_image:
        image_tokens = IMG_START_TOKEN + IMG_CONTEXT_TOKEN * (num_image_token * n_tiles) + IMG_END_TOKEN
        text = text.replace("<image>", image_tokens, 1)
    if "<image>" in text:
        raise ValueError("more <image> markers than images")
    return text


def get_question_template(task_type: str = "rec") -> str:
    """The InternVL REC question template (internvl_module.py:154-156)."""
    return (
        'Given the question: "{Question}", please provide the bounding box where you '
        "can find the asnwer to the question. First output the thinking process in "
        "<think> </think> tags and then output the final answer (the bbox) in "
        "<answer> </answer> tags. Output the bounding box of that region as pixel "
        "coordinates in the form <bbox>[x1,y1,x2,y2]</bbox>. Use integers, no spaces"
    )


def prepare_internvl_batch(
    cfg: InternVLVLMConfig,
    token_lists: Sequence[Sequence[int]],
    vision_embeds,
    *,
    length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS,
) -> PreparedBatch:
    """Pack prompts + PRECOMPUTED vision embeddings into a PreparedBatch.

    InternVL uses plain sequential positions (no M-RoPE): every rotary plane carries
    arange, which reduces exactly to 1D RoPE under any mrope_section split.
    vision_embeds (N_tokens, E) is kept as given: a tensor stays on its device (the
    reference converts its device array with np.asarray)."""
    B = len(token_lists)
    lengths = np.asarray([len(t) for t in token_lists], dtype=np.int32)
    S = bucket(int(lengths.max()), length_buckets)
    ids = np.full((B, S), cfg.tokens.pad, dtype=np.int32)
    for b, toks in enumerate(token_lists):
        ids[b, : len(toks)] = toks
    pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy().astype(np.int32)
    return PreparedBatch(
        input_ids=ids, lengths=lengths, position_ids=pos, next_pos=lengths.copy(),
        pixel_values=vision_embeds,
        vision_meta=None,  # None + pixel_values == embeds-input (Generator._vision_kwargs)
    )


class InternVLRunner:
    """Two-piece InternVL inference: InternViT embeds on the device + the shared
    Generator. The prompt bucket is DEFAULT_LENGTH_BUCKETS' (largest 2048), as in the
    reference: a prompt whose tiles take it past 2048 tokens raises ValueError."""

    def __init__(self, params, cfg: InternVLVLMConfig, tokenizer, *, max_cache_len: int = 4096,
                 max_anyres_num: int = 12, cache_dtype=None, device=None):
        """params: a tree on `device` (None: cuda; raises without a CUDA device)."""
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if any(t.device != device for t in tree_leaves(params)):
            raise ValueError(f"InternVLRunner: the parameters must be on {device}")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_anyres_num = max_anyres_num
        self.device = device
        self.generator = Generator(params, cfg, max_cache_len=max_cache_len, cache_dtype=cache_dtype)

    def tile_images(self, images: Sequence) -> Tuple[np.ndarray, List[int]]:
        """PIL images -> (packed patches (T, n_patches, patch_dim) float32, tiles per
        image) via anyres tiling (host work)."""
        all_tiles, counts = [], []
        for img in images:
            tiles = load_image_anyres(img, input_size=self.cfg.vision.image_size,
                                      max_num=self.max_anyres_num, use_thumbnail=True)
            all_tiles.append(tiles)
            counts.append(tiles.shape[0])
        packed = np.concatenate(all_tiles, axis=0)
        return patchify_tiles(packed, self.cfg.vision.patch_size), counts

    @torch.inference_mode()
    def encode_images(self, images: Sequence) -> Tuple[torch.Tensor, List[int]]:
        """PIL images -> (packed vision embeds on the device, tiles per image): one
        InternViT call over all the images' tiles."""
        patches, counts = self.tile_images(images)
        x = torch.as_tensor(patches, device=self.device)
        return internvit_embeds(self.params["vision"], self.cfg.vision, x), counts

    def prepare(self, questions: Sequence[str], embeds, counts: Sequence[int]) -> PreparedBatch:
        """The batch generate() prefills: each question in the chat template with its
        image's tiles expanded into <IMG_CONTEXT> tokens."""
        nit = self.cfg.vision.num_image_token
        token_lists = []
        for q, n_tiles in zip(questions, counts):
            text = expand_image_tokens(chat_prompt(q), [n_tiles], nit)
            token_lists.append(self.tokenizer.encode(text))
        return prepare_internvl_batch(self.cfg, token_lists, embeds)

    def generate(self, questions: Sequence[str], images: Sequence,
                 gen: GenerationConfig = GenerationConfig(), *, seed: int = 0) -> List[str]:
        """Batched single-image chat generation (embeds-input path)."""
        embeds, counts = self.encode_images(images)
        batch = self.prepare(questions, embeds, counts)
        out = self.generator.generate(batch, gen, seed=seed)
        return [self.tokenizer.decode(t).strip() for t in out]
