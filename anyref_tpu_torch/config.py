"""Typed configuration: a copy of anyref_tpu/config.py (the port keeps its
own copy and imports nothing of the JAX package). One frozen, hashable config
tree with the presets ``anyref_7b`` and ``anyref_tiny``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Token layout
# ---------------------------------------------------------------------------
# The reference adds special tokens to a LLaMA tokenizer in a fixed order
# (reference train.py:100-131). We pin an explicit integer layout on top of the
# 32000-token LLaMA base vocab; the embedding table is padded to a multiple of
# 128 for TPU lane alignment.
LLAMA_BASE_VOCAB = 32000

@dataclass(frozen=True)
class SpecialTokens:
    """Integer ids of the added special tokens (fixed layout)."""

    seg: int = 32000            # "[SEG]"
    im_start: int = 32001       # "<im_start>"
    im_end: int = 32002         # "<im_end>"
    audio_ref_start: int = 32003  # "<audio_ref_start>"
    audio_ref_end: int = 32004    # "<audio_ref_end>"
    img_ref_start: int = 32005    # "<img_ref_start>"
    img_ref_end: int = 32006      # "<img_ref_end>"
    image: int = 32007          # "<image>" placeholder, expands to 256 patches
    img_ref: int = 32008        # "<img_ref>" placeholder (x IMG_REF_NUM)
    audio_ref: int = 32009      # "<audio_ref>" placeholder (x AUDIO_REF_NUM)
    loc0: int = 32010           # "[LOC0]"; [LOCi] = loc0 + i, i in [0, 100]
    num_loc: int = 101

    @property
    def loc_end(self) -> int:
        return self.loc0 + self.num_loc - 1  # inclusive

    @property
    def num_added(self) -> int:
        return 10 + self.num_loc


IGNORE_INDEX = -100
IMAGE_TOKEN_STR = "<image>"
IMG_REF_NUM = 4     # reference model/llava constants (anyref.py:337-338 call sites)
AUDIO_REF_NUM = 3   # ImageBind yields 3 clips per audio (data.py:121 clips_per_video)
NUM_IMAGE_TOKENS = 256  # 224/14 = 16 -> 16*16 CLIP patches (anyref.py:282 "+255")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# The port's four paths through the image towers (SAM and CLIP), chosen by an
# explicit argument of every entry point; each is one configuration of the
# JAX package's switches:
# * "fused" (the default): the reference's default on its accelerator,
#   ANYREF_FUSED_WINDOW_BLOCK=1 ANYREF_FUSED_GLOBAL_BLOCK=1
#   ANYREF_FUSED_SPLIT=1 ANYREF_QKV_MHA_KERNEL=1 ANYREF_QKV_WINDOW_KERNEL=0:
#   a SAM window layer as fused_window_attn + fused_mlp_stream, a global
#   layer as fused_global_tail, where the reference's gates take the
#   shape; CLIP attention read off the fused QKV;
# * "fused_block": ANYREF_FUSED_WINDOW_BLOCK=1 ANYREF_FUSED_GLOBAL_BLOCK=1
#   ANYREF_FUSED_SPLIT=0 ANYREF_QKV_MHA_KERNEL=1 ANYREF_QKV_WINDOW_KERNEL=0:
#   as "fused", with a window layer as one fused_window_block (its
#   post-attention residual kept in fp32 into the MLP half);
# * "unfused_qkv": ANYREF_FUSED_WINDOW_BLOCK=0 ANYREF_FUSED_GLOBAL_BLOCK=0
#   ANYREF_QKV_WINDOW_KERNEL=1 ANYREF_QKV_MHA_KERNEL=1, the reference's
#   default off its accelerator: SAM blocks op by op, attention over grids
#   of 64 <= H * W < 1024 tokens (the windows) read off the fused QKV
#   (flash_relpos_attention_qkv), larger grids split into heads for the
#   rel-pos attention kernel; CLIP attention read off the fused QKV;
# * "unfused": ANYREF_FUSED_WINDOW_BLOCK=0 ANYREF_FUSED_GLOBAL_BLOCK=0
#   ANYREF_QKV_WINDOW_KERNEL=0 ANYREF_QKV_MHA_KERNEL=0: SAM blocks op by
#   op with the rel-pos attention kernel, CLIP attention plain.
ENCODER_PATHS = ("fused", "fused_block", "unfused_qkv", "unfused")


def check_encoder_path(path: str) -> str:
    if path not in ENCODER_PATHS:
        raise ValueError(f"encoder_path must be one of {ENCODER_PATHS}, got "
                         f"{path!r}")
    return path


# ---------------------------------------------------------------------------
# LLaMA decoder
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA-7B decoder (reference LLaVA-Lightning-7B-v1-1 backbone)."""

    vocab_size: int = LLAMA_BASE_VOCAB + SpecialTokens().num_added
    padded_vocab_size: int = round_up(LLAMA_BASE_VOCAB + SpecialTokens().num_added, 128)
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 512 + NUM_IMAGE_TOKENS  # model_max_length 512 (train.py:62) + image expansion


# ---------------------------------------------------------------------------
# CLIP vision tower (ViT-L/14, penultimate-layer patch features as in LLaVA)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    # LLaVA uses hidden_states[-2] ("mm_vision_select_layer" = -2) and drops CLS
    # ("mm_vision_select_feature" = "patch", reference anyref.py:173).
    select_layer: int = -2

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SamConfig:
    """SAM ViT variants (reference build_sam.py:15-53)."""

    encoder_embed_dim: int = 1280
    encoder_depth: int = 32
    encoder_num_heads: int = 16
    encoder_global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    image_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    mlp_ratio: float = 4.0
    prompt_embed_dim: int = 256
    mask_decoder_depth: int = 2
    mask_decoder_heads: int = 8
    mask_decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6

    @property
    def embedding_size(self) -> int:
        return self.image_size // self.patch_size  # 64

    @classmethod
    def vit_h(cls) -> "SamConfig":
        return cls()

    @classmethod
    def vit_l(cls) -> "SamConfig":
        return cls(encoder_embed_dim=1024, encoder_depth=24, encoder_num_heads=16,
                   encoder_global_attn_indexes=(5, 11, 17, 23))

    @classmethod
    def vit_b(cls) -> "SamConfig":
        return cls(encoder_embed_dim=768, encoder_depth=12, encoder_num_heads=12,
                   encoder_global_attn_indexes=(2, 5, 8, 11))


SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


# ---------------------------------------------------------------------------
# ImageBind audio branch
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ImageBindAudioConfig:
    """Audio-only slice of ImageBind-huge (reference imagebind_model.py:514-541;
    AnyRef deletes all other modalities, anyref.py:142-147)."""

    embed_dim: int = 768
    num_blocks: int = 12
    num_heads: int = 12
    out_embed_dim: int = 1024
    mel_bins: int = 128
    target_len: int = 204
    kernel_size: int = 16
    stride: int = 10
    logit_scale_init: float = 20.0
    # audio front-end (reference data.py:114-161)
    sample_rate: int = 16000
    clip_duration: float = 2.0
    clips_per_audio: int = 3
    mel_mean: float = -4.268
    mel_std: float = 9.138


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AnyRefConfig:
    llama: LlamaConfig = field(default_factory=LlamaConfig)
    clip: ClipVisionConfig = field(default_factory=ClipVisionConfig)
    sam: SamConfig = field(default_factory=SamConfig.vit_h)
    audio: Optional[ImageBindAudioConfig] = field(default_factory=ImageBindAudioConfig)
    tokens: SpecialTokens = field(default_factory=SpecialTokens)

    out_dim: int = 256                   # [SEG] projection dim (train.py:310)
    ce_loss_weight: float = 1.0          # anyref.py:193
    dice_loss_weight: float = 0.5        # anyref.py:194
    bce_loss_weight: float = 2.0         # anyref.py:195
    rephrase_weight: float = 0.0         # anyref.py:209 (0.1 at referseg eval)
    use_loc_tokens: bool = False         # reference with_bbox (train.py:72)
    loc_weight: float = 0.1              # train.py:320
    max_new_tokens: int = 128            # anyref.py:660

    # static-shape budgets (TPU: no dynamic shapes inside jit)
    max_text_len: int = 512              # tokens before image expansion
    max_seg_per_sample: int = 8          # [SEG] tokens per sample, masked beyond actual

    @property
    def max_seq_len(self) -> int:
        return self.max_text_len + NUM_IMAGE_TOKENS - 1

    def scaled(self, **kw) -> "AnyRefConfig":
        return dataclasses.replace(self, **kw)


def anyref_7b() -> AnyRefConfig:
    """Flagship preset mirroring the reference (LLaMA-7B + CLIP-L + SAM-H)."""
    return AnyRefConfig()


def anyref_tiny() -> AnyRefConfig:
    """Tiny preset for unit tests and CPU-mesh dry runs. Same wiring, small dims."""
    return AnyRefConfig(
        llama=LlamaConfig(
            vocab_size=LLAMA_BASE_VOCAB + SpecialTokens().num_added,
            padded_vocab_size=round_up(LLAMA_BASE_VOCAB + SpecialTokens().num_added, 128),
            hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=4, num_kv_heads=4, head_dim=32, max_seq_len=768),
        clip=ClipVisionConfig(hidden_size=64, num_layers=2, num_heads=4,
                              intermediate_size=128),
        sam=SamConfig(encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=2,
                      encoder_global_attn_indexes=(1,), image_size=256,
                      window_size=4, prompt_embed_dim=32,
                      mask_decoder_mlp_dim=64, iou_head_hidden_dim=32),
        audio=ImageBindAudioConfig(embed_dim=32, num_blocks=2, num_heads=2,
                                   out_embed_dim=48),
        out_dim=32,
        # byte-fallback tokenizer yields ~1 token/char; keep room for the
        # full system prompt + question + answer
        max_text_len=384,
    )
