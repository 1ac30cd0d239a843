"""Typed configuration of the latent video diffusion stage, DUSt3R and the
global alignment.

The port's own copy of the JAX package's presets (same dataclasses, same
numbers), so that the port imports nothing of the JAX package.

Replaces the reference's two-tier OmegaConf-YAML + reflective
`instantiate_from_config` system (configs/inference_pvd_1024.yaml,
utils/diffusion_utils.py:31-46) with frozen dataclasses and an explicit
registry of named presets — no dotted-path dynamic imports.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """3D U-Net denoiser (cf. configs/inference_pvd_1024.yaml:33-64 and
    lvdm/modules/networks/openaimodel3d.py:311-546)."""

    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    temporal_conv: bool = True
    temporal_attention: bool = True
    temporal_length: int = 16
    addition_attention: bool = True
    image_cross_attention: bool = True
    text_context_len: int = 77
    default_fs: int = 10
    fs_condition: bool = True
    use_causal_attention: bool = False
    # Shaw-style learned relative-position bias in temporal attention
    # (reference `use_relative_position`, attention.py:20-39 + 322-340;
    # off in every shipped config but config-parity supported)
    use_relative_position: bool = False


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """First-stage KL-VAE (configs/inference_pvd_1024.yaml:66-87)."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    embed_dim: int = 4
    z_channels: int = 4

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """IP-Adapter Perceiver resampler (configs/inference_pvd_1024.yaml:100-111)."""

    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280
    output_dim: int = 1024
    ff_mult: int = 4
    video_length: int = 16


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """OpenCLIP ViT-H/14 text tower, penultimate layer
    (lvdm/modules/encoders/condition.py:174-234)."""

    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    penultimate: bool = True


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """OpenCLIP ViT-H/14 visual tower, all 257 pre-pool tokens
    (lvdm/modules/encoders/condition.py:295-372)."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    heads: int = 16
    layers: int = 32


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """VIPLatentDiffusion-level knobs (configs/inference_pvd_1024.yaml:6-31)."""

    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.00085
    linear_end: float = 0.012
    rescale_betas_zero_snr: bool = True
    parameterization: str = "v"
    scale_factor: float = 0.18215
    use_dynamic_rescale: bool = True
    base_scale: float = 0.3
    turning_step: int = 400
    perframe_ae: bool = True
    uncond_type: str = "empty_seq"
    latent_size: Tuple[int, int] = (72, 128)  # (h, w) of latents


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One full LVDM model family (denoiser + stages)."""

    name: str
    diffusion: DiffusionConfig = DiffusionConfig()
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    resampler: ResamplerConfig = ResamplerConfig()
    clip_text: CLIPTextConfig = CLIPTextConfig()
    clip_vision: CLIPVisionConfig = CLIPVisionConfig()
    video_length: int = 25
    height: int = 576
    width: int = 1024


@dataclasses.dataclass(frozen=True)
class Dust3rConfig:
    """AsymmetricCroCo3DStereo ViT-L/Base-decoder/DPT at 512
    (extern/dust3r/dust3r/model.py:154 and croco defaults)."""

    img_size: Tuple[int, int] = (512, 512)  # max; actual inputs are multiples of 16
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_freq: float = 100.0
    dpt_feature_dim: int = 256
    dpt_hidden_dims: Tuple[int, ...] = (96, 192, 384, 768)
    head_type: str = "dpt"  # or "linear"
    depth_mode: str = "exp"  # pts = d/|d| * expm1(|d|)
    conf_mode: str = "exp"  # conf = 1 + exp(x)


DUST3R_REGISTRY = {
    # the released DUSt3R_ViTLarge_BaseDecoder_512_dpt architecture
    "dust3r_512": Dust3rConfig(),
    # dev/test preset: tiny dims, same topology (used by tests and CLI smoke)
    "dust3r_tiny": Dust3rConfig(
        enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
        dec_embed_dim=32, dec_depth=4, dec_num_heads=2,
        dpt_feature_dim=16, dpt_hidden_dims=(8, 8, 16, 32),
    ),
}


def get_dust3r_config(name: str) -> Dust3rConfig:
    try:
        return DUST3R_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown dust3r model {name!r}; available: {sorted(DUST3R_REGISTRY)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Global point-cloud alignment (extern/dust3r/dust3r/cloud_opt)."""

    niter: int = 300
    lr: float = 0.01
    schedule: str = "linear"
    min_conf_thr: float = 3.0
    focal_break: float = 20.0


# ---------------------------------------------------------------------------
# Registry of named presets (the four reference model variants).
# ---------------------------------------------------------------------------

MODEL_REGISTRY: Dict[str, ModelConfig] = {}


def register_model(cfg: ModelConfig) -> ModelConfig:
    MODEL_REGISTRY[cfg.name] = cfg
    return cfg


register_model(ModelConfig(name="viewcrafter_25"))  # 576x1024, 25 frames

register_model(
    ModelConfig(
        name="viewcrafter_16",
        video_length=16,
    )
)

register_model(
    ModelConfig(
        name="viewcrafter_25_512",  # 320x512, 25 frames (inference_pvd_512.yaml)
        diffusion=DiffusionConfig(base_scale=0.7, latent_size=(40, 64)),
        height=320,
        width=512,
    )
)


register_model(
    ModelConfig(
        name="viewcrafter_tiny",  # dev/test preset: tiny dims, same topology
        diffusion=DiffusionConfig(latent_size=(4, 8)),
        unet=UNetConfig(
            model_channels=32, num_res_blocks=1, attention_resolutions=(1, 2),
            channel_mult=(1, 2), num_head_channels=16, context_dim=64,
            temporal_length=4,
        ),
        vae=VAEConfig(ch=32, ch_mult=(1, 2, 4, 4)),
        resampler=ResamplerConfig(
            dim=64, depth=1, dim_head=16, heads=4, num_queries=4,
            embedding_dim=48, output_dim=64, video_length=4,
        ),
        clip_text=CLIPTextConfig(vocab_size=49408, width=64, heads=2, layers=2),
        clip_vision=CLIPVisionConfig(image_size=224, patch_size=56, width=48, heads=2, layers=2),
        video_length=4,
        height=32,
        width=64,
    )
)


def get_model_config(name: str) -> ModelConfig:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}") from None
