"""Model/runtime configuration (the port's own copy of zoomearth_tpu/config.py).

Dataclass configs for the Qwen2.5-VL model family (ZoomEarth's backbone is
Qwen2.5-VL-3B) plus a tiny config used by the test-suite for CPU parity tests.

All special-token ids live here (never hardcoded in logic — the reference hardcodes
eos id 151643 at grpo_trainer.py:578, a defect SURVEY.md §2.6 says not to replicate).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import ClassVar, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Qwen2.5-VL vision tower config (windowed ViT with 2D RoPE + 2x2 patch merge)."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112  # pixels; 8x8 merged patches per window
    fullatt_block_indexes: Sequence[int] = (7, 15, 23, 31)
    out_hidden_size: int = 2048
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-6
    # Family variants: Qwen2.5-VL uses RMSNorm + SwiGLU + windowed attention;
    # Qwen2-VL (reference modeling_qwen2_vl.py:387-470) uses LayerNorm + GELU fc1/fc2
    # MLP + full attention in every block (fullatt_block_indexes covers all).
    norm_type: str = "rms"  # "rms" | "layer"
    mlp_type: str = "swiglu"  # "swiglu" | "gelu_fc"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size**2


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Qwen2.5 decoder config (GQA + M-RoPE + RMSNorm + SwiGLU)."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 128
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 128000
    # M-RoPE: how many rotary freq pairs go to (temporal, height, width).
    # Mirrors reference modeling_qwen2_vl.py:985-1100 (get_rope_index) semantics.
    mrope_section: Sequence[int] = (16, 24, 24)

    # the module of models/ that runs a layer's attention (None: models/decoder.py's GQA)
    attention_kind: ClassVar[Optional[str]] = None

    def layer_attention(self, i: int):
        """The config layer i's attention runs by (every layer: this one)."""
        return self

    def is_moe_layer(self, i: int) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Qwen2.5-VL special token ids (tokenizer_config values for the released model)."""

    image_pad: int = 151655
    video_pad: int = 151656
    vision_start: int = 151652
    vision_end: int = 151653
    im_start: int = 151644
    im_end: int = 151645
    endoftext: int = 151643  # used as pad
    eos: int = 151645  # <|im_end|> terminates assistant turns

    @property
    def pad(self) -> int:
        return self.endoftext


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    tokens: SpecialTokens = dataclasses.field(default_factory=SpecialTokens)
    dtype: str = "bfloat16"  # compute/storage dtype for params

    @staticmethod
    def qwen2_5_vl_3b() -> "VLMConfig":
        """The reference backbone (Qwen2.5-VL-3B-Instruct)."""
        return VLMConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "VLMConfig":
        """Tiny config for CPU tests; structurally identical (windowed ViT, GQA, M-RoPE).

        Dimensions picked so HF transformers accepts them (head_dim divisibility,
        spatial-merge divisibility) while staying fast on one CPU core.
        """
        vision = VisionConfig(
            depth=4,
            hidden_size=32,
            intermediate_size=64,
            num_heads=4,
            patch_size=14,
            temporal_patch_size=2,
            spatial_merge_size=2,
            window_size=56,  # 2x2 merged patches per window
            fullatt_block_indexes=(2,),
            out_hidden_size=64,
        )
        text = TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            rope_theta=1000000.0,
            tie_word_embeddings=True,
            mrope_section=(2, 3, 3),
        )
        tokens = SpecialTokens(
            image_pad=databank_id(vocab_size, 0),
            video_pad=databank_id(vocab_size, 1),
            vision_start=databank_id(vocab_size, 2),
            vision_end=databank_id(vocab_size, 3),
            im_start=databank_id(vocab_size, 4),
            im_end=databank_id(vocab_size, 5),
            endoftext=databank_id(vocab_size, 6),
            eos=databank_id(vocab_size, 5),
        )
        return VLMConfig(vision=vision, text=text, tokens=tokens, dtype="float32")

    @staticmethod
    def from_hf_dir(path: str) -> "VLMConfig":
        """Build a config from an HF checkpoint directory's config.json."""
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        v = cfg.get("vision_config", {})
        is_qwen2_vl = cfg.get("model_type") == "qwen2_vl" or "embed_dim" in v
        if is_qwen2_vl:
            # Qwen2-VL ViT (reference modeling_qwen2_vl.py:665-784): embed_dim naming,
            # mlp_ratio, LayerNorm + quick_gelu fc MLP, full attention in every block.
            embed_dim = v.get("embed_dim", 1280)
            depth = v.get("depth", 32)
            vision = VisionConfig(
                depth=depth,
                hidden_size=embed_dim,
                intermediate_size=int(embed_dim * v.get("mlp_ratio", 4)),
                num_heads=v.get("num_heads", 16),
                in_channels=v.get("in_channels", v.get("in_chans", 3)),
                patch_size=v.get("patch_size", 14),
                temporal_patch_size=v.get("temporal_patch_size", 2),
                spatial_merge_size=v.get("spatial_merge_size", 2),
                window_size=10**9,  # unused: every block is full attention
                fullatt_block_indexes=tuple(range(depth)),
                out_hidden_size=v.get("hidden_size", cfg.get("hidden_size", 2048)),
                hidden_act=v.get("hidden_act", "quick_gelu"),
                norm_type="layer",
                mlp_type="gelu_fc",
            )
        else:
            vision = VisionConfig(
                depth=v.get("depth", 32),
                hidden_size=v.get("hidden_size", 1280),
                intermediate_size=v.get("intermediate_size", 3420),
                num_heads=v.get("num_heads", 16),
                in_channels=v.get("in_channels", v.get("in_chans", 3)),
                patch_size=v.get("patch_size", 14),
                temporal_patch_size=v.get("temporal_patch_size", 2),
                spatial_merge_size=v.get("spatial_merge_size", 2),
                window_size=v.get("window_size", 112),
                fullatt_block_indexes=tuple(v.get("fullatt_block_indexes", (7, 15, 23, 31))),
                out_hidden_size=v.get("out_hidden_size", 2048),
            )
        text = TextConfig(
            vocab_size=cfg.get("vocab_size", 151936),
            hidden_size=cfg.get("hidden_size", 2048),
            intermediate_size=cfg.get("intermediate_size", 11008),
            num_hidden_layers=cfg.get("num_hidden_layers", 36),
            num_attention_heads=cfg.get("num_attention_heads", 16),
            num_key_value_heads=cfg.get("num_key_value_heads", 2),
            head_dim=cfg.get("head_dim", cfg.get("hidden_size", 2048) // cfg.get("num_attention_heads", 16)),
            rope_theta=cfg.get("rope_theta", 1000000.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=cfg.get("tie_word_embeddings", True),
            max_position_embeddings=cfg.get("max_position_embeddings", 128000),
            mrope_section=tuple(cfg.get("rope_scaling", {}).get("mrope_section", (16, 24, 24))),
        )
        tokens = SpecialTokens(
            image_pad=cfg.get("image_token_id", 151655),
            video_pad=cfg.get("video_token_id", 151656),
            vision_start=cfg.get("vision_start_token_id", 151652),
            vision_end=cfg.get("vision_end_token_id", 151653),
            eos=cfg.get("eos_token_id", 151645),
        )
        return VLMConfig(vision=vision, text=text, tokens=tokens)


@dataclasses.dataclass(frozen=True)
class InternVitConfig:
    """InternViT tower (HF transformers InternVLVisionConfig semantics): plain ViT with
    CLS token + learned absolute position embeddings, pre-LN blocks with layer-scale,
    full (unwindowed) attention, pixel-shuffle 2x downsample + 2-layer MLP projector
    (reference family: vlm_modules/internvl_module.py; modeling via HF internvl)."""

    depth: int = 24
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_heads: int = 16
    in_channels: int = 3
    image_size: int = 448
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    use_qk_norm: bool = False
    layer_scale_init: float = 0.1
    norm_type: str = "layer_norm"  # "layer_norm" | "rms_norm"
    attention_bias: bool = False
    hidden_act: str = "gelu"
    downsample_ratio: float = 0.5
    projector_hidden_act: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.patch_size**2

    @property
    def num_image_token(self) -> int:
        """LLM tokens per tile after pixel-shuffle downsampling."""
        side = int(self.patches_per_side * self.downsample_ratio)
        return side * side


@dataclasses.dataclass(frozen=True)
class InternVLTokens:
    """InternVL special ids (HF InternVLConfig defaults for the Qwen2-based family)."""

    image_context: int = 151667  # <IMG_CONTEXT> — the expanded placeholder
    img_start: int = 151665  # <img>
    img_end: int = 151666  # </img>
    im_start: int = 151644
    im_end: int = 151645
    endoftext: int = 151643
    eos: int = 151645

    @property
    def pad(self) -> int:
        return self.endoftext

    @property
    def image_pad(self) -> int:
        # generation runtime alias: the token whose embeddings get replaced
        return self.image_context


@dataclasses.dataclass(frozen=True)
class InternVLVLMConfig:
    """Second VLM family: InternViT vision + Qwen2-style decoder (plain 1D RoPE —
    positions are sequential even across image tokens, unlike Qwen-VL's M-RoPE)."""

    vision: InternVitConfig = dataclasses.field(default_factory=InternVitConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    tokens: InternVLTokens = dataclasses.field(default_factory=InternVLTokens)
    dtype: str = "bfloat16"

    @staticmethod
    def tiny(vocab_size: int = 512) -> "InternVLVLMConfig":
        vision = InternVitConfig(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
            image_size=28, patch_size=14, use_qk_norm=True,
        )
        text = TextConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, tie_word_embeddings=True,
            mrope_section=(8,),  # single section == plain 1D RoPE
        )
        tokens = InternVLTokens(
            image_context=databank_id(vocab_size, 7),
            img_start=databank_id(vocab_size, 8),
            img_end=databank_id(vocab_size, 9),
            im_start=databank_id(vocab_size, 4),
            im_end=databank_id(vocab_size, 5),
            endoftext=databank_id(vocab_size, 6),
            eos=databank_id(vocab_size, 5),
        )
        return InternVLVLMConfig(vision=vision, text=text, tokens=tokens, dtype="float32")


def databank_id(vocab_size: int, slot: int) -> int:
    """Reserve special-token ids at the top of a (tiny) vocab, mirroring Qwen's layout
    where specials sit at the end of the vocab."""
    return vocab_size - 16 + slot


@dataclasses.dataclass(frozen=True)
class MoonViTConfig:
    """Kimi-VL's vision tower (MoonViT, models/moonvit.py): a native-resolution ViT with
    a learned 64 x 64 position grid resized to each image, 2D RoPE, LayerNorm blocks
    with a GELU (tanh) MLP, and a 2 x 2 patch merge into an MLP projector. Patches are
    one frame of 14 x 14 x 3 (temporal_patch_size 1 for the processor's patchify)."""

    depth: int = 27
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    init_pos_emb_height: int = 64
    init_pos_emb_width: int = 64
    merge_kernel_size: Sequence[int] = (2, 2)
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    out_hidden_size: int = 2048  # the decoder's hidden size
    image_mean: float = 0.5  # the image processor's per-channel mean and std
    image_std: float = 0.5
    temporal_patch_size: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.patch_size**2

    @property
    def spatial_merge_size(self) -> int:
        return self.merge_kernel_size[0]

    @property
    def merge_unit(self) -> int:
        return self.merge_kernel_size[0] * self.merge_kernel_size[1]


@dataclasses.dataclass(frozen=True)
class KimiTextConfig:
    """The DeepSeek-V3-style decoder of Kimi-VL (models/mla.py, models/moe.py): latent
    attention (MLA, no q low-rank) in every layer, a dense SwiGLU in the first
    `first_k_dense_replace` layers and routed experts (sigmoid noaux_tc router with a
    score-correction bias, shared experts) after them. Field names are the HF config's."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 131072

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token keeps per layer in the latent cache: [c (kv_lora_rank) | k_r]."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def __post_init__(self):
        # what models/mla.py and models/moe.py compute; a config asking for another variant is refused
        if (self.q_lora_rank is not None or self.scoring_func != "sigmoid" or self.topk_method != "noaux_tc"
                or self.n_group != 1 or self.topk_group != 1):
            raise NotImplementedError(
                f"KimiTextConfig: the port runs q without a low rank and one group of sigmoid noaux_tc routing "
                f"(q_lora_rank={self.q_lora_rank}, scoring_func={self.scoring_func!r}, topk_method="
                f"{self.topk_method!r}, n_group={self.n_group}, topk_group={self.topk_group})")

    attention_kind: ClassVar[str] = "mla"  # models/mla.py
    experts_held: ClassVar[Optional[Tuple[int, int]]] = None  # every routed expert on this device

    def layer_attention(self, i: int):
        return self

    def is_moe_layer(self, i: int) -> bool:
        return i >= self.first_k_dense_replace and i % self.moe_layer_freq == 0


@dataclasses.dataclass(frozen=True)
class KimiTokens:
    """Kimi-VL's special ids. The runtime reads image_pad (the media placeholder), pad,
    eos and endoftext (both stop a row: <|im_end|> ends an assistant turn, [EOS] the
    text); `strings()` is the byte-level tokenizer's map of special strings."""

    media_pad: int = 163605
    media_start: int = 163602
    media_content: int = 163603
    media_end: int = 163604
    im_user: int = 163587
    im_assistant: int = 163588
    im_system: int = 163594
    im_middle: int = 163601
    im_end: int = 163586
    bos: int = 163584
    endoftext: int = 163585
    pad: int = 163839

    @property
    def image_pad(self) -> int:
        return self.media_pad

    @property
    def eos(self) -> int:
        return self.im_end

    def strings(self) -> dict:
        return {"<|media_pad|>": self.media_pad, "<|media_start|>": self.media_start,
                "<|media_content|>": self.media_content, "<|media_end|>": self.media_end,
                "<|im_user|>": self.im_user, "<|im_assistant|>": self.im_assistant,
                "<|im_system|>": self.im_system, "<|im_middle|>": self.im_middle, "<|im_end|>": self.im_end,
                "[BOS]": self.bos, "[EOS]": self.endoftext, "[PAD]": self.pad}


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    """Kimi-VL-A3B-Instruct: MoonViT + the MLA / MoE decoder, with plain 1D positions
    (image tokens take sequential positions; no M-RoPE). 16.4 B parameters, 2.8 B
    active a token."""

    vision: MoonViTConfig = dataclasses.field(default_factory=MoonViTConfig)
    text: KimiTextConfig = dataclasses.field(default_factory=KimiTextConfig)
    tokens: KimiTokens = dataclasses.field(default_factory=KimiTokens)
    dtype: str = "bfloat16"

    @staticmethod
    def tiny(vocab_size: int = 512) -> "KimiVLConfig":
        """Tiny config for CPU tests: every kind of layer (MoonViT blocks with a head
        width off the kernels' grid, one dense and two MoE decoder layers, MLA with
        narrow latent and rotary parts), fp32."""
        vision = MoonViTConfig(depth=2, hidden_size=48, intermediate_size=64, num_heads=2,
                               init_pos_emb_height=8, init_pos_emb_width=8, out_hidden_size=64)
        text = KimiTextConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=96, moe_intermediate_size=16,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1,
            n_routed_experts=8, kv_lora_rank=32, qk_rope_head_dim=16, v_head_dim=16, qk_nope_head_dim=16,
            num_experts_per_tok=3, max_position_embeddings=4096,
        )
        tokens = KimiTokens(**{name: databank_id(vocab_size, slot) for slot, name in enumerate(
            ("media_pad", "media_start", "media_content", "media_end", "im_user", "im_assistant", "im_system",
             "im_middle", "im_end", "bos", "endoftext", "pad"))})
        return KimiVLConfig(vision=vision, text=text, tokens=tokens, dtype="float32")

    @staticmethod
    def from_dict(cfg: dict) -> "KimiVLConfig":
        """From a Kimi-VL config.json (text keys under `text_config`, or at the top level
        as the benchmark's configuration file has them) and its `vision_config`; special
        ids from `special_token_ids` where given."""
        t = cfg.get("text_config", cfg)
        text = KimiTextConfig(**{f.name: t[f.name] for f in dataclasses.fields(KimiTextConfig) if f.name in t})
        v = cfg.get("vision_config", {})
        names = {f.name for f in dataclasses.fields(MoonViTConfig)}
        vkw = {k: v[k] for k in names if k in v}
        if "num_hidden_layers" in v:
            vkw["depth"] = v["num_hidden_layers"]
        if "num_attention_heads" in v:
            vkw["num_heads"] = v["num_attention_heads"]
        if "merge_kernel_size" in vkw:
            vkw["merge_kernel_size"] = tuple(vkw["merge_kernel_size"])
        vkw["out_hidden_size"] = text.hidden_size
        tokens = KimiTokens(**cfg.get("special_token_ids", {}))
        if "media_placeholder_token_id" in cfg:
            tokens = dataclasses.replace(tokens, media_pad=cfg["media_placeholder_token_id"])
        return KimiVLConfig(vision=MoonViTConfig(**vkw), text=text, tokens=tokens,
                            dtype=cfg.get("torch_dtype", t.get("torch_dtype", "bfloat16")))

    @staticmethod
    def from_file(path: str) -> "KimiVLConfig":
        """From a config.json file, or a checkpoint directory that holds one."""
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as f:
            return KimiVLConfig.from_dict(json.load(f))


@dataclasses.dataclass(frozen=True)
class HybridAttention:
    """One kind of MiMo-V2.5's attention layers (models/hybrid.py): H query heads over
    Hkv key/value heads, keys qk_head_dim and values v_head_dim wide, the 1D rotary over
    the first rope_dim dims of q and k with its own theta; window > 0: the query at
    position p sees the keys at p - window + 1 .. p (0: every earlier key); sink: a
    learned logit per head that joins each row's softmax as one more column whose value
    is 0; the heads' outputs times value_scale before the output product."""

    attention_kind: ClassVar[str] = "hybrid"  # models/hybrid.py
    num_attention_heads: int
    num_key_value_heads: int
    qk_head_dim: int
    v_head_dim: int
    rope_dim: int
    rope_theta: float
    window: int
    sink: bool
    value_scale: float


@dataclasses.dataclass(frozen=True)
class MiMoTextConfig:
    """MiMo-V2.5's decoder (the MiMo-V2-Flash family): `hybrid_layer_pattern` gives each
    layer's kind, 0 global (full causal GQA) and 1 sliding-window (with a learned sink
    per head), each kind with its own heads, widths and rotary theta; `moe_layer_freq`
    gives each layer's MLP, 0 a dense SwiGLU and 1 routed experts (sigmoid noaux_tc with
    a score-correction bias, top num_experts_per_tok, no shared expert). Field names are
    the HF config's. `experts_held` is the range of routed experts this device holds
    (expert parallelism: the router keeps its n_routed_experts outputs, the layer
    computes the picks that land on its own experts); None holds them all."""

    vocab_size: int = 152576
    hidden_size: int = 4096
    intermediate_size: int = 16384
    moe_intermediate_size: int = 2048
    num_hidden_layers: int = 48
    num_attention_heads: int = 64
    num_key_value_heads: int = 4
    head_dim: int = 192
    v_head_dim: int = 128
    swa_num_attention_heads: int = 64
    swa_num_key_value_heads: int = 8
    swa_head_dim: int = 192
    swa_v_head_dim: int = 128
    sliding_window: int = 128
    hybrid_layer_pattern: Sequence[int] = (0,) + (1, 1, 1, 1, 0) + (1, 1, 1, 1, 1, 0) * 7
    moe_layer_freq: Sequence[int] = (0,) + (1,) * 47
    n_routed_experts: int = 256
    num_experts_per_tok: int = 8
    n_shared_experts: Optional[int] = None
    routed_scaling_factor: Optional[float] = None
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    partial_rotary_factor: float = 0.334
    rope_theta: float = 10000000.0
    swa_rope_theta: float = 10000.0
    add_swa_attention_sink_bias: bool = True
    add_full_attention_sink_bias: bool = False
    attention_value_scale: float = 0.707
    attention_bias: bool = False
    layernorm_epsilon: float = 1e-5
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 1048576
    experts_held: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        # what models/hybrid.py and models/moe.py compute; a config asking for another variant is refused
        held = self.experts_held
        if (self.scoring_func != "sigmoid" or self.topk_method != "noaux_tc" or self.n_group != 1
                or self.topk_group != 1 or self.attention_bias or self.n_shared_experts
                or self.add_full_attention_sink_bias
                or len(self.hybrid_layer_pattern) < self.num_hidden_layers
                or len(self.moe_layer_freq) < self.num_hidden_layers
                or (held is not None and not 0 <= held[0] < held[1] <= self.n_routed_experts)):
            raise NotImplementedError(
                f"MiMoTextConfig: the port runs one group of sigmoid noaux_tc routing without shared experts, "
                f"attention without bias, sinks in the window layers only, a kind and an MLP for every layer and "
                f"a held range inside the router (add_full_attention_sink_bias={self.add_full_attention_sink_bias}, "
                f"(scoring_func={self.scoring_func!r}, topk_method={self.topk_method!r}, n_group={self.n_group}, "
                f"topk_group={self.topk_group}, attention_bias={self.attention_bias}, n_shared_experts="
                f"{self.n_shared_experts}, layers {self.num_hidden_layers} with {len(self.hybrid_layer_pattern)} "
                f"kinds and {len(self.moe_layer_freq)} MLPs, experts_held={held})")
        kinds = (HybridAttention(self.num_attention_heads, self.num_key_value_heads, self.head_dim, self.v_head_dim,
                                 self._rope_dim(self.head_dim), self.rope_theta, 0,
                                 self.add_full_attention_sink_bias, self.attention_value_scale),
                 HybridAttention(self.swa_num_attention_heads, self.swa_num_key_value_heads, self.swa_head_dim,
                                 self.swa_v_head_dim, self._rope_dim(self.swa_head_dim), self.swa_rope_theta,
                                 self.sliding_window, self.add_swa_attention_sink_bias, self.attention_value_scale))
        object.__setattr__(self, "_kinds", kinds)

    def _rope_dim(self, head_dim: int) -> int:
        return int(head_dim * self.partial_rotary_factor)

    @property
    def rms_norm_eps(self) -> float:
        return self.layernorm_epsilon

    @property
    def held(self) -> Tuple[int, int]:
        """The routed experts this device holds, [first, end)."""
        return tuple(self.experts_held) if self.experts_held is not None else (0, self.n_routed_experts)

    def layer_attention(self, i: int) -> HybridAttention:
        """Layer i's attention: the global kind (pattern 0) or the window kind (1)."""
        return self._kinds[self.hybrid_layer_pattern[i]]

    def is_moe_layer(self, i: int) -> bool:
        return bool(self.moe_layer_freq[i])


@dataclasses.dataclass(frozen=True)
class MiMoV2Config:
    """MiMo-V2.5 on the zoom episode: the Qwen2.5-VL vision tower (models/vit.py, a
    stand-in until the published vision_config is known) with its output at the
    decoder's width, the hybrid decoder (MiMoTextConfig), plain 1D positions (image
    tokens take sequential positions), and ChatML's special ids (Qwen's layout)."""

    vision: VisionConfig = dataclasses.field(default_factory=lambda: VisionConfig(out_hidden_size=4096))
    text: MiMoTextConfig = dataclasses.field(default_factory=MiMoTextConfig)
    tokens: SpecialTokens = dataclasses.field(default_factory=SpecialTokens)
    dtype: str = "bfloat16"

    @staticmethod
    def tiny(vocab_size: int = 512) -> "MiMoV2Config":
        """Tiny config for CPU tests: both attention kinds (a window of 8, sinks), key
        width apart from value width, partial rotary, one dense and three routed layers
        with 16 experts of which this device holds 8, fp32."""
        vision = dataclasses.replace(VLMConfig.tiny(vocab_size).vision, out_hidden_size=64)
        text = MiMoTextConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=96, moe_intermediate_size=16,
            num_hidden_layers=5, num_attention_heads=4, num_key_value_heads=1, head_dim=24, v_head_dim=16,
            swa_num_attention_heads=4, swa_num_key_value_heads=2, swa_head_dim=24, swa_v_head_dim=16,
            sliding_window=8, hybrid_layer_pattern=(0, 1, 1, 0, 1), moe_layer_freq=(0, 1, 1, 1, 1),
            n_routed_experts=16, num_experts_per_tok=4, partial_rotary_factor=0.334, experts_held=(8, 16),
            max_position_embeddings=4096)
        return MiMoV2Config(vision=vision, text=text, tokens=VLMConfig.tiny(vocab_size).tokens, dtype="float32")

    @staticmethod
    def from_dict(cfg: dict) -> "MiMoV2Config":
        """From a configuration in the benchmark's layout: the decoder's HF keys at the top
        level, `vision_config` (Qwen2.5-VL's keys), the special ids (Qwen's key names) and
        `expert_parallel` ({"size", "rank"}: the devices that share each routed layer and
        this one's place; `n_routed_experts` then counts the experts held here, the router's
        width being size x that)."""
        rope = cfg.get("rope_scaling") or {}
        if (cfg.get("attention_chunk_size", cfg.get("sliding_window")) != cfg.get("sliding_window")
                or cfg.get("hybrid_block_size") is not None or rope.get("rope_type", "default") != "default"
                or cfg.get("attention_projection_layout", "fused_qkv") != "fused_qkv"):
            raise NotImplementedError(
                f"MiMoV2Config: the port runs the window as the only local mask (attention_chunk_size equal to "
                f"sliding_window), no hybrid blocks, the default rotary and the fused q | k | v product "
                f"(attention_chunk_size={cfg.get('attention_chunk_size')}, hybrid_block_size="
                f"{cfg.get('hybrid_block_size')}, rope_scaling={rope}, attention_projection_layout="
                f"{cfg.get('attention_projection_layout')!r})")
        names = {f.name for f in dataclasses.fields(MiMoTextConfig)}
        kw = {k: cfg[k] for k in names if k in cfg}
        for k in ("hybrid_layer_pattern", "moe_layer_freq"):
            if k in kw:
                kw[k] = tuple(kw[k])
        ep = cfg.get("expert_parallel")
        if ep is not None:
            held = cfg["n_routed_experts"]
            kw["n_routed_experts"] = held * ep["size"]
            kw["experts_held"] = (held * ep["rank"], held * (ep["rank"] + 1))
        v = cfg.get("vision_config", {})
        vkw = {f.name: v[f.name] for f in dataclasses.fields(VisionConfig) if f.name in v}
        if "fullatt_block_indexes" in vkw:
            vkw["fullatt_block_indexes"] = tuple(vkw["fullatt_block_indexes"])
        if "in_chans" in v:
            vkw["in_channels"] = v["in_chans"]
        vkw["out_hidden_size"] = cfg.get("hidden_size", 4096)
        sp = cfg.get("special_token_ids", {})
        tokens = SpecialTokens(**{k: sp[k] for k in (f.name for f in dataclasses.fields(SpecialTokens)) if k in sp})
        return MiMoV2Config(vision=VisionConfig(**vkw), text=MiMoTextConfig(**kw), tokens=tokens,
                            dtype=cfg.get("torch_dtype", "bfloat16"))


def is_kimi(cfg) -> bool:
    """Whether a model config is Kimi-VL's (MoonViT, 1D positions, MLA / MoE decoder)."""
    return isinstance(cfg, KimiVLConfig)
