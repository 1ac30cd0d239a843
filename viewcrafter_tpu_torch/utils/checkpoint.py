"""Load the released PyTorch checkpoints into the port.

The port's own copy of the JAX package's checkpoint translator
(utils/checkpoint.py there), written for the port's state-dict names. Both
the reference and the port are PyTorch, so a weight keeps its layout: a
Linear's (out, in), a Conv's (out, in, kh, kw), a Conv3d's (out, in, 3, 1,
1) and a ConvTranspose2d's (in, out, kh, kw) (the JAX package flips the
last one for flax; the port convolves as torch does). What changes is the
name, and in two places the shape:
  - the UNet's `init_attn` projections are 1x1 Conv1d in the reference
    ((out, in, 1) weights), Linear in the port;
  - the relative-position tables are `relative_position_{k,v}.embeddings_table`
    there, `rel_{k,v}_table` here.

The reference's loading quirks are kept (utils/diffusion_utils.py:83-108):
the Lightning `state_dict` wrapper, deepspeed's `module.` prefix, the legacy
`framestride_embed -> fps_embedding` rename, and DUSt3R's duplication of
`dec_blocks.*` into `dec_blocks2.*` when a file has no second decoder
(extern/dust3r/dust3r/model.py:46-53). The DUSt3R file's constructor string
(`args`) is never evaluated: the architecture comes from `Dust3rConfig`.

Entry points: `lvdm_from_reference`, `dust3r_from_reference`,
`croco_pretrain_from_reference` and `croco_downstream_from_reference`
(strict: a
port parameter left unfilled, a checkpoint key a map needs and does not
find, or a shape that differs raises with the list of keys; checkpoint keys
no map takes are ignored), and their inverses `lvdm_to_reference`,
`dust3r_to_reference`, `croco_pretrain_to_reference` and
`croco_downstream_to_reference`, which write port weights under the
reference's names.

The training loop's own save/resume (`save_params` / `load_params`) is the
other half: the JAX package writes its loop state with orbax, the port with
`torch.save`.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Mapping, Optional

import torch

from viewcrafter_tpu_torch.config import Dust3rConfig, ModelConfig, UNetConfig, VAEConfig

LVDM_PREFIXES = {
    "unet": "model.diffusion_model",
    "vae": "first_stage_model",
    "clip_text": "cond_stage_model.model",
    "clip_vision": "embedder.model.visual",
    "resampler": "image_proj_model",
}


class _Walk:
    """One pass of a map over the reference's names beside the port's.
    Forward, `src` is a reference state dict and `out` fills with port keys;
    inverse, `src` is a port state dict and `out` fills with reference keys.
    `missing` collects the (reference, port) pairs whose source key is
    absent."""

    def __init__(self, src: Mapping, inverse: bool = False):
        self.src, self.inverse = src, inverse
        self.out: Dict[str, torch.Tensor] = {}
        self.used: set = set()
        self.missing: list = []

    def has(self, ref: str, port: str) -> bool:
        return (port if self.inverse else ref) in self.src

    def copy(self, ref: str, port: str, to_port=None, to_ref=None) -> None:
        key, dst, fn = (port, ref, to_ref) if self.inverse else (ref, port, to_port)
        if key not in self.src:
            self.missing.append((ref, port))
            return
        self.used.add(key)
        val = self.src[key]
        self.out[dst] = fn(val) if fn is not None else val

    def linear(self, ref: str, port: str, bias: bool = True) -> None:
        """Linear, Conv2d, Conv3d and ConvTranspose2d alike: torch's layout
        on both sides."""
        self.copy(f"{ref}.weight", f"{port}.weight")
        if bias and self.has(f"{ref}.bias", f"{port}.bias"):
            self.copy(f"{ref}.bias", f"{port}.bias")

    conv = linear

    def norm(self, ref: str, port: str) -> None:
        self.copy(f"{ref}.weight", f"{port}.weight")
        self.copy(f"{ref}.bias", f"{port}.bias")


# ---------------------------------------------------------------------------
# state-dict normalization (the reference's quirks)
# ---------------------------------------------------------------------------


def normalize_lvdm_state_dict(raw: Mapping) -> dict:
    """Unwrap the Lightning / deepspeed containers and apply the legacy key
    rename (utils/diffusion_utils.py:83-108)."""
    sd = raw.get("state_dict", raw)
    if "module" in sd and isinstance(sd["module"], Mapping):  # deepspeed
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd["module"].items()}
    return {k.replace("framestride_embed", "fps_embedding"): v for k, v in sd.items()}


def normalize_dust3r_state_dict(raw: Mapping) -> dict:
    """Unwrap `model` and give a file without a second decoder one, a copy
    of the first (extern/dust3r/dust3r/model.py:46-53)."""
    sd = raw.get("model", raw)
    if not any(k.startswith("dec_blocks2") for k in sd):
        extra = {k.replace("dec_blocks", "dec_blocks2"): v for k, v in sd.items()
                 if k.startswith("dec_blocks.")}
        sd = {**sd, **extra}
    return dict(sd)


def load_torch_file(path: str) -> dict:
    """A torch .ckpt / .pth on the CPU, weights only where the file allows
    (the DUSt3R file pickles its argparse namespace)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return torch.load(path, map_location="cpu", weights_only=False)


# ---------------------------------------------------------------------------
# UNet3D
# ---------------------------------------------------------------------------


def _map_resblock(w: _Walk, src: str, dst: str) -> None:
    w.norm(f"{src}.in_layers.0", f"{dst}.in_norm")
    w.conv(f"{src}.in_layers.2", f"{dst}.in_conv")
    w.linear(f"{src}.emb_layers.1", f"{dst}.emb_proj")
    w.norm(f"{src}.out_layers.0", f"{dst}.out_norm")
    w.conv(f"{src}.out_layers.3", f"{dst}.out_conv")
    if w.has(f"{src}.skip_connection.weight", f"{dst}.skip.weight"):
        w.conv(f"{src}.skip_connection", f"{dst}.skip")
    if w.has(f"{src}.temopral_conv.conv1.0.weight", f"{dst}.temporal_conv.norm_0.weight"):
        # the reference's TemporalConvBlock (sic "temopral"): 4x GN + SiLU +
        # Conv3d, a dropout shifting the conv's index in blocks 2-4
        for i, conv in enumerate(("conv1", "conv2", "conv3", "conv4")):
            w.norm(f"{src}.temopral_conv.{conv}.0", f"{dst}.temporal_conv.norm_{i}")
            w.conv(f"{src}.temopral_conv.{conv}.{2 if i == 0 else 3}",
                   f"{dst}.temporal_conv.conv_{i}")


def _map_attention(w: _Walk, src: str, dst: str, rel_pos: bool = False) -> None:
    for name in ("to_q", "to_k", "to_v"):
        w.linear(f"{src}.{name}", f"{dst}.{name}", bias=False)
    w.linear(f"{src}.to_out.0", f"{dst}.to_out")
    if w.has(f"{src}.to_k_ip.weight", f"{dst}.to_k_ip.weight"):
        w.linear(f"{src}.to_k_ip", f"{dst}.to_k_ip", bias=False)
        w.linear(f"{src}.to_v_ip", f"{dst}.to_v_ip", bias=False)
    # Shaw-style relative-position tables, (2L+1, dim_head) as they are
    if rel_pos and w.has(f"{src}.relative_position_k.embeddings_table", f"{dst}.rel_k_table"):
        w.copy(f"{src}.relative_position_k.embeddings_table", f"{dst}.rel_k_table")
        w.copy(f"{src}.relative_position_v.embeddings_table", f"{dst}.rel_v_table")


def _map_transformer_block(w: _Walk, src: str, dst: str, rel_pos: bool = False) -> None:
    _map_attention(w, f"{src}.attn1", f"{dst}.attn1", rel_pos=rel_pos)
    _map_attention(w, f"{src}.attn2", f"{dst}.attn2", rel_pos=rel_pos)
    for name in ("norm1", "norm2", "norm3"):
        w.norm(f"{src}.{name}", f"{dst}.{name}")
    w.linear(f"{src}.ff.net.0.proj", f"{dst}.ff.geglu.proj")
    w.linear(f"{src}.ff.net.2", f"{dst}.ff.out")


def _proj_linear_or_conv1d(w: _Walk, src: str, dst: str, conv1d: bool) -> None:
    """proj_in / proj_out: Linear in every body transformer (`use_linear:
    true`), a 1x1 Conv1d with an (out, in, 1) weight in the UNet's
    init_attn, which omits the flag (attention.py:267,288,
    openaimodel3d.py:391). The port's is a Linear either way; the inverse
    writes the reference's form (`conv1d`)."""
    w.copy(f"{src}.weight", f"{dst}.weight",
           to_port=lambda t: t[:, :, 0] if t.ndim == 3 else t,
           to_ref=(lambda t: t[:, :, None]) if conv1d else None)
    if w.has(f"{src}.bias", f"{dst}.bias"):
        w.copy(f"{src}.bias", f"{dst}.bias")


def _map_spatial_transformer(w: _Walk, src: str, dst: str, depth: int, rel_pos: bool = False,
                             conv1d: bool = False) -> None:
    w.norm(f"{src}.norm", f"{dst}.norm")
    _proj_linear_or_conv1d(w, f"{src}.proj_in", f"{dst}.proj_in", conv1d)
    _proj_linear_or_conv1d(w, f"{src}.proj_out", f"{dst}.proj_out", conv1d)
    for d in range(depth):
        _map_transformer_block(w, f"{src}.transformer_blocks.{d}", f"{dst}.block_{d}",
                               rel_pos=rel_pos)


def map_unet(w: _Walk, cfg: UNetConfig, src_prefix: str = LVDM_PREFIXES["unet"]) -> None:
    p, depth, rel = src_prefix, cfg.transformer_depth, cfg.use_relative_position
    w.linear(f"{p}.time_embed.0", "time_embed_0")
    w.linear(f"{p}.time_embed.2", "time_embed_2")
    if w.has(f"{p}.fps_embedding.0.weight", "fps_embed_0.weight"):
        w.linear(f"{p}.fps_embedding.0", "fps_embed_0")
        w.linear(f"{p}.fps_embedding.2", "fps_embed_2")
    w.conv(f"{p}.input_blocks.0.0", "in_conv")
    if w.has(f"{p}.init_attn.0.norm.weight", "init_attn.norm.weight"):
        _map_spatial_transformer(w, f"{p}.init_attn.0", "init_attn", depth, rel_pos=rel,
                                 conv1d=True)

    idx, ds = 1, 1
    for level, _ in enumerate(cfg.channel_mult):
        for j in range(cfg.num_res_blocks):
            base = f"{p}.input_blocks.{idx}"
            _map_resblock(w, f"{base}.0", f"down_{level}_{j}_res")
            if ds in cfg.attention_resolutions:
                _map_spatial_transformer(w, f"{base}.1", f"down_{level}_{j}_spatial", depth)
                if cfg.temporal_attention:
                    _map_spatial_transformer(w, f"{base}.2", f"down_{level}_{j}_temporal", depth,
                                             rel_pos=rel)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            w.conv(f"{p}.input_blocks.{idx}.0.op", f"down_{level}_downsample.op")
            idx += 1
            ds *= 2

    _map_resblock(w, f"{p}.middle_block.0", "mid_res1")
    _map_spatial_transformer(w, f"{p}.middle_block.1", "mid_spatial", depth)
    off = 2
    if cfg.temporal_attention:
        _map_spatial_transformer(w, f"{p}.middle_block.2", "mid_temporal", depth, rel_pos=rel)
        off = 3
    _map_resblock(w, f"{p}.middle_block.{off}", "mid_res2")

    idx = 0
    for level, _ in list(enumerate(cfg.channel_mult))[::-1]:
        for j in range(cfg.num_res_blocks + 1):
            base = f"{p}.output_blocks.{idx}"
            _map_resblock(w, f"{base}.0", f"up_{level}_{j}_res")
            k = 1
            if ds in cfg.attention_resolutions:
                _map_spatial_transformer(w, f"{base}.{k}", f"up_{level}_{j}_spatial", depth)
                k += 1
                if cfg.temporal_attention:
                    _map_spatial_transformer(w, f"{base}.{k}", f"up_{level}_{j}_temporal", depth,
                                             rel_pos=rel)
                    k += 1
            if level and j == cfg.num_res_blocks:
                w.conv(f"{base}.{k}.conv", f"up_{level}_upsample.conv")
                ds //= 2
            idx += 1

    w.norm(f"{p}.out.0", "out_norm")
    w.conv(f"{p}.out.2", "out_conv")


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _map_vae_resblock(w: _Walk, src: str, dst: str) -> None:
    w.norm(f"{src}.norm1", f"{dst}.norm1")
    w.conv(f"{src}.conv1", f"{dst}.conv1")
    w.norm(f"{src}.norm2", f"{dst}.norm2")
    w.conv(f"{src}.conv2", f"{dst}.conv2")
    if w.has(f"{src}.nin_shortcut.weight", f"{dst}.nin_shortcut.weight"):
        w.conv(f"{src}.nin_shortcut", f"{dst}.nin_shortcut")


def map_vae(w: _Walk, cfg: VAEConfig, src_prefix: str = LVDM_PREFIXES["vae"]) -> None:
    p = src_prefix
    levels = range(len(cfg.ch_mult))
    for tower in ("encoder", "decoder"):
        tp = f"{p}.{tower}"
        w.conv(f"{tp}.conv_in", f"{tower}.conv_in")
        w.norm(f"{tp}.norm_out", f"{tower}.norm_out")
        w.conv(f"{tp}.conv_out", f"{tower}.conv_out")
        _map_vae_resblock(w, f"{tp}.mid.block_1", f"{tower}.mid_block_1")
        w.norm(f"{tp}.mid.attn_1.norm", f"{tower}.mid_attn_1.norm")
        for name in ("q", "k", "v", "proj_out"):
            w.conv(f"{tp}.mid.attn_1.{name}", f"{tower}.mid_attn_1.{name}")
        _map_vae_resblock(w, f"{tp}.mid.block_2", f"{tower}.mid_block_2")
        # the decoder's up[i] is indexed by level (0 the finest), as the
        # encoder's down[i]
        part, blocks = (("down", cfg.num_res_blocks) if tower == "encoder"
                        else ("up", cfg.num_res_blocks + 1))
        resample = "downsample" if tower == "encoder" else "upsample"
        for i in levels:
            for j in range(blocks):
                _map_vae_resblock(w, f"{tp}.{part}.{i}.block.{j}", f"{tower}.{part}_{i}_block_{j}")
            if w.has(f"{tp}.{part}.{i}.{resample}.conv.weight",
                     f"{tower}.{part}_{i}_{resample}.conv.weight"):
                w.conv(f"{tp}.{part}.{i}.{resample}.conv", f"{tower}.{part}_{i}_{resample}.conv")
    w.conv(f"{p}.quant_conv", "quant_conv")
    w.conv(f"{p}.post_quant_conv", "post_quant_conv")


# ---------------------------------------------------------------------------
# CLIP towers and the Resampler
# ---------------------------------------------------------------------------


def _map_clip_block(w: _Walk, src: str, dst: str) -> None:
    w.norm(f"{src}.ln_1", f"{dst}.ln_1")
    w.norm(f"{src}.ln_2", f"{dst}.ln_2")
    # open_clip's fused (3C, C) in-projection, one Linear in the port too
    w.copy(f"{src}.attn.in_proj_weight", f"{dst}.in_proj.weight")
    w.copy(f"{src}.attn.in_proj_bias", f"{dst}.in_proj.bias")
    w.linear(f"{src}.attn.out_proj", f"{dst}.out_proj")
    w.linear(f"{src}.mlp.c_fc", f"{dst}.c_fc")
    w.linear(f"{src}.mlp.c_proj", f"{dst}.c_proj")


def map_clip_text(w: _Walk, layers: int, src_prefix: str = LVDM_PREFIXES["clip_text"]) -> None:
    p = src_prefix
    w.copy(f"{p}.token_embedding.weight", "token_embedding.weight")
    w.copy(f"{p}.positional_embedding", "positional_embedding")
    w.norm(f"{p}.ln_final", "ln_final")
    for i in range(layers):
        _map_clip_block(w, f"{p}.transformer.resblocks.{i}", f"block_{i}")


def map_clip_vision(w: _Walk, layers: int,
                    src_prefix: str = LVDM_PREFIXES["clip_vision"]) -> None:
    p = src_prefix
    w.copy(f"{p}.conv1.weight", "conv1.weight")
    w.copy(f"{p}.class_embedding", "class_embedding")
    w.copy(f"{p}.positional_embedding", "positional_embedding")
    w.norm(f"{p}.ln_pre", "ln_pre")
    for i in range(layers):
        _map_clip_block(w, f"{p}.transformer.resblocks.{i}", f"block_{i}")


def map_resampler(w: _Walk, depth: int, src_prefix: str = LVDM_PREFIXES["resampler"]) -> None:
    p = src_prefix
    w.copy(f"{p}.latents", "latents")
    w.linear(f"{p}.proj_in", "proj_in")
    w.linear(f"{p}.proj_out", "proj_out")
    w.norm(f"{p}.norm_out", "norm_out")
    for i in range(depth):
        a, f = f"{p}.layers.{i}.0", f"{p}.layers.{i}.1"
        w.norm(f"{a}.norm1", f"layer_{i}_attn.norm1")
        w.norm(f"{a}.norm2", f"layer_{i}_attn.norm2")
        for name in ("to_q", "to_kv", "to_out"):
            w.linear(f"{a}.{name}", f"layer_{i}_attn.{name}", bias=False)
        w.norm(f"{f}.0", f"layer_{i}_ff.norm")
        w.linear(f"{f}.1", f"layer_{i}_ff.fc1", bias=False)
        w.linear(f"{f}.3", f"layer_{i}_ff.fc2", bias=False)


def _lvdm_maps(cfg: ModelConfig):
    return {
        "unet": lambda w: map_unet(w, cfg.unet),
        "vae": lambda w: map_vae(w, cfg.vae),
        "clip_text": lambda w: map_clip_text(w, cfg.clip_text.layers),
        "clip_vision": lambda w: map_clip_vision(w, cfg.clip_vision.layers),
        "resampler": lambda w: map_resampler(w, cfg.resampler.depth),
    }


# ---------------------------------------------------------------------------
# DUSt3R
# ---------------------------------------------------------------------------


def _map_croco_enc_block(w: _Walk, src: str, dst: str) -> None:
    w.norm(f"{src}.norm1", f"{dst}.norm1")
    w.norm(f"{src}.norm2", f"{dst}.norm2")
    for name in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
        w.linear(f"{src}.{name}", f"{dst}.{name}")


def _map_croco_dec_block(w: _Walk, src: str, dst: str) -> None:
    for name in ("norm1", "norm2", "norm3", "norm_y"):
        w.norm(f"{src}.{name}", f"{dst}.{name}")
    for name in ("attn.qkv", "attn.proj", "cross_attn.projq", "cross_attn.projk",
                 "cross_attn.projv", "cross_attn.proj", "mlp.fc1", "mlp.fc2"):
        w.linear(f"{src}.{name}", f"{dst}.{name}")


def _map_dpt_head(w: _Walk, src: str, dst: str) -> None:
    # act_postprocess: [0] a 1x1 conv, [1] a ConvTranspose2d (x4, x2) at
    # levels 1 and 2, a stride-2 conv at level 4
    d = f"{src}.dpt"
    w.conv(f"{d}.act_postprocess.0.0", f"{dst}.act1_proj")
    w.conv(f"{d}.act_postprocess.0.1", f"{dst}.act1_up")
    w.conv(f"{d}.act_postprocess.1.0", f"{dst}.act2_proj")
    w.conv(f"{d}.act_postprocess.1.1", f"{dst}.act2_up")
    w.conv(f"{d}.act_postprocess.2.0", f"{dst}.act3_proj")
    w.conv(f"{d}.act_postprocess.3.0", f"{dst}.act4_proj")
    w.conv(f"{d}.act_postprocess.3.1", f"{dst}.act4_down")
    for i in range(1, 5):
        w.conv(f"{d}.scratch.layer{i}_rn", f"{dst}.layer{i}_rn", bias=False)
        rsrc, rdst = f"{d}.scratch.refinenet{i}", f"{dst}.refinenet{i}"
        # refinenet4 (the pyramid's top) has no skip input, so its
        # resConfUnit1 never runs in the reference and the port has none
        units = (("resConfUnit2", "rcu2"),) if i == 4 else (
            ("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2"))
        for unit, name in units:
            if w.has(f"{rsrc}.{unit}.conv1.weight", f"{rdst}.{name}.conv1.weight"):
                w.conv(f"{rsrc}.{unit}.conv1", f"{rdst}.{name}.conv1")
                w.conv(f"{rsrc}.{unit}.conv2", f"{rdst}.{name}.conv2")
        w.conv(f"{rsrc}.out_conv", f"{rdst}.out_conv")
    for i, k in enumerate((0, 2, 4)):
        w.conv(f"{d}.head.{k}", f"{dst}.head_conv{i + 1}")


def map_dust3r(w: _Walk, cfg: Dust3rConfig) -> None:
    w.conv("patch_embed.proj", "encoder.patch_embed")
    w.norm("enc_norm", "encoder.norm")
    for i in range(cfg.enc_depth):
        _map_croco_enc_block(w, f"enc_blocks.{i}", f"encoder.block_{i}")
    w.linear("decoder_embed", "decoder.decoder_embed")
    w.norm("dec_norm", "decoder.norm")
    for i in range(cfg.dec_depth):
        _map_croco_dec_block(w, f"dec_blocks.{i}", f"decoder.block1_{i}")
        _map_croco_dec_block(w, f"dec_blocks2.{i}", f"decoder.block2_{i}")
    for s in ("1", "2"):
        if cfg.head_type == "dpt":
            _map_dpt_head(w, f"downstream_head{s}", f"head{s}")
        else:
            w.linear(f"downstream_head{s}.proj", f"head{s}.proj")


def map_croco_pretrain(w: _Walk, enc_depth: int, dec_depth: int) -> None:
    """The reference CroCoNet (croco/models/croco.py:21-115) -> the port's
    `models.croco_pretrain.CroCoPretrain`."""
    w.conv("patch_embed.proj", "patch_embed")
    w.norm("enc_norm", "enc_norm")
    for i in range(enc_depth):
        _map_croco_enc_block(w, f"enc_blocks.{i}", f"enc_block_{i}")
    w.linear("decoder_embed", "decoder_embed")
    w.copy("mask_token", "mask_token")
    w.norm("dec_norm", "dec_norm")
    for i in range(dec_depth):
        _map_croco_dec_block(w, f"dec_blocks.{i}", f"dec_block_{i}")
    w.linear("prediction_head", "prediction_head")


def map_croco_downstream(w: _Walk, cfg, monocular: bool = False) -> None:
    """The reference CroCoDownstreamBinocular / CroCoDownstreamMonocularEncoder
    (croco/models/croco_downstream.py:23-122, its head's `head.dpt.*`
    adapter from head_downstream.py) -> the port's
    `models.croco_downstream` model of `cfg`; the monocular model has no
    decoder."""
    w.conv("patch_embed.proj", "patch_embed")
    w.norm("enc_norm", "enc_norm")
    for i in range(cfg.enc_depth):
        _map_croco_enc_block(w, f"enc_blocks.{i}", f"enc_block_{i}")
    if not monocular:
        w.linear("decoder_embed", "decoder_embed")
        w.norm("dec_norm", "dec_norm")
        for i in range(cfg.dec_depth):
            _map_croco_dec_block(w, f"dec_blocks.{i}", f"dec_block_{i}")
    _map_dpt_head(w, "head", "head")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lvdm_param_shapes(cfg: ModelConfig) -> Dict[str, Dict[str, torch.Size]]:
    """{submodel: {key: shape}} of the port's diffusion stack at `cfg`, from
    modules built on the meta device (no memory, no init)."""
    from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, VideoDiffusionEngine

    eng = VideoDiffusionEngine(cfg, dtype=torch.float32, device="meta")
    return {n: {k: v.shape for k, v in getattr(eng, n).state_dict().items()} for n in SUBMODELS}


def dust3r_param_shapes(cfg: Dust3rConfig) -> Dict[str, torch.Size]:
    from viewcrafter_tpu_torch.models.dust3r import Dust3rModel

    with torch.device("meta"):
        model = Dust3rModel(cfg, dtype=torch.float32)
    return {k: v.shape for k, v in model.state_dict().items()}


def croco_pretrain_param_shapes(cfg) -> Dict[str, torch.Size]:
    from viewcrafter_tpu_torch.models.croco_pretrain import CroCoPretrain

    with torch.device("meta"):
        model = CroCoPretrain(cfg, dtype=torch.float32)
    return {k: v.shape for k, v in model.state_dict().items()}


def croco_downstream_param_shapes(cfg, monocular: bool = False) -> Dict[str, torch.Size]:
    from viewcrafter_tpu_torch.models.croco_downstream import (
        CroCoDownstreamBinocular, CroCoDownstreamMonocularEncoder)

    cls = CroCoDownstreamMonocularEncoder if monocular else CroCoDownstreamBinocular
    with torch.device("meta"):
        model = cls(cfg, dtype=torch.float32)
    return {k: v.shape for k, v in model.state_dict().items()}


def _as_tensor(val, key: str) -> torch.Tensor:
    if not isinstance(val, torch.Tensor):
        val = torch.as_tensor(val)
    if val.dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise ValueError(f"checkpoint key {key}: dtype {val.dtype}, expected a float type")
    return val


def _check(what: str, walk: _Walk, shapes: Mapping[str, torch.Size]) -> list:
    """The strictness check: one line per missing source key, port
    parameter left unfilled, unexpected port key or differing shape."""
    errs = [f"missing: {port} (checkpoint key {ref})" for ref, port in walk.missing]
    missing_ports = {port for _, port in walk.missing}
    errs += [f"unfilled: {k}" for k in sorted(set(shapes) - set(walk.out) - missing_ports)]
    errs += [f"unexpected: {k}" for k in sorted(set(walk.out) - set(shapes))]
    for k in sorted(set(walk.out) & set(shapes)):
        if tuple(walk.out[k].shape) != tuple(shapes[k]):
            errs.append(f"shape {k}: checkpoint {tuple(walk.out[k].shape)} vs model "
                        f"{tuple(shapes[k])}")
    return [f"{what}: {e}" for e in errs]


def _raise(kind: str, errs: list) -> None:
    if errs:
        more = f"\n... and {len(errs) - 40} more" if len(errs) > 40 else ""
        raise ValueError(f"{kind} checkpoint does not match the model ({len(errs)} problems):\n"
                         + "\n".join(errs[:40]) + more)


def lvdm_from_reference(raw: Mapping, model_cfg: ModelConfig,
                        shapes: Optional[Mapping] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """A released diffusion checkpoint (as `load_torch_file` returns it) ->
    {submodel: port state dict} for `VideoDiffusionEngine.load_params`.
    Leaves keep their dtype (float32, float16 or bfloat16). `shapes`: the
    port's {submodel: {key: shape}} when the caller has them (else built on
    the meta device)."""
    sd = normalize_lvdm_state_dict(raw)
    shapes = shapes or lvdm_param_shapes(model_cfg)
    out, errs = {}, []
    for name, walk_fn in _lvdm_maps(model_cfg).items():
        walk = _Walk(sd)
        walk_fn(walk)
        errs += _check(name, walk, shapes[name])
        out[name] = {k: _as_tensor(v, k) for k, v in walk.out.items()}
    _raise("diffusion", errs)
    return out


def dust3r_from_reference(raw: Mapping, dust3r_cfg: Dust3rConfig,
                          shapes: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """A released DUSt3R checkpoint -> a state dict for the port's
    `models.dust3r.Dust3rModel`, strictly as `lvdm_from_reference`."""
    walk = _Walk(normalize_dust3r_state_dict(raw))
    map_dust3r(walk, dust3r_cfg)
    _raise("DUSt3R", _check("dust3r", walk, shapes or dust3r_param_shapes(dust3r_cfg)))
    return {k: _as_tensor(v, k) for k, v in walk.out.items()}


def croco_pretrain_from_reference(raw: Mapping, cfg,
                                  shapes: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """A reference CroCo pretraining checkpoint (its `model` entry, or the
    state dict itself) -> a state dict for the port's `CroCoPretrain` at
    `cfg` (a `CroCoPretrainConfig`), strictly as `lvdm_from_reference`."""
    walk = _Walk(dict(raw.get("model", raw)))
    map_croco_pretrain(walk, cfg.enc_depth, cfg.dec_depth)
    _raise("CroCo", _check("croco_pretrain", walk, shapes or croco_pretrain_param_shapes(cfg)))
    return {k: _as_tensor(v, k) for k, v in walk.out.items()}


def croco_downstream_from_reference(raw: Mapping, cfg,
                                    monocular: bool = False) -> Dict[str, torch.Tensor]:
    """A released CroCo-Stereo / CroCo-Flow checkpoint (its `model` entry, or
    the state dict itself) -> a state dict for the port's
    `CroCoDownstreamBinocular` (or, `monocular`, the encoder-only model) at
    `cfg` (a `CroCoDownstreamConfig`), strictly as `lvdm_from_reference`.
    The reference's `args` are not read: the topology is `cfg`'s."""
    walk = _Walk(dict(raw.get("model", raw)))
    map_croco_downstream(walk, cfg, monocular)
    _raise("CroCo downstream", _check("croco_downstream", walk,
                                      croco_downstream_param_shapes(cfg, monocular)))
    return {k: _as_tensor(v, k) for k, v in walk.out.items()}


def _inverse(walk_fn, state: Mapping) -> Dict[str, torch.Tensor]:
    walk = _Walk(state, inverse=True)
    walk_fn(walk)
    unused = sorted(set(state) - walk.used)
    if walk.missing or unused:
        raise ValueError(f"port state does not fit the map: missing "
                         f"{[p for _, p in walk.missing][:20]}, unused {unused[:20]}")
    return walk.out


def lvdm_to_reference(state: Mapping[str, Mapping],
                      model_cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """{submodel: port state dict} -> one flat state dict under the released
    checkpoint's names (init_attn's projections as (out, in, 1) Conv1d
    weights). Every port key must be used."""
    out = {}
    for name, walk_fn in _lvdm_maps(model_cfg).items():
        out.update(_inverse(walk_fn, state[name]))
    return out


def dust3r_to_reference(state: Mapping, dust3r_cfg: Dust3rConfig) -> Dict[str, torch.Tensor]:
    """A port DUSt3R state dict -> the released checkpoint's names (both
    decoders written)."""
    return _inverse(lambda w: map_dust3r(w, dust3r_cfg), state)


def croco_pretrain_to_reference(state: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """A port `CroCoPretrain` state dict -> the reference CroCoNet's names."""
    return _inverse(lambda w: map_croco_pretrain(w, cfg.enc_depth, cfg.dec_depth), state)


def croco_downstream_to_reference(state: Mapping, cfg,
                                  monocular: bool = False) -> Dict[str, torch.Tensor]:
    """A port downstream state dict -> the reference model's names."""
    return _inverse(lambda w: map_croco_downstream(w, cfg, monocular), state)


# ---------------------------------------------------------------------------
# our own save/resume
# ---------------------------------------------------------------------------


def _encode(obj: Any) -> Any:
    """A loop state as dicts, lists, tensors and numbers: a dataclass of this
    package under its qualified name, a torch.Generator as its device and
    state."""
    if dataclasses.is_dataclass(obj):
        cls = type(obj)
        return {"__dataclass__": f"{cls.__module__}:{cls.__qualname__}",
                **{f.name: _encode(getattr(obj, f.name)) for f in dataclasses.fields(obj)}}
    if isinstance(obj, torch.Generator):
        return {"__generator__": str(obj.device), "state": obj.get_state()}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    return obj


def _decode(obj: Any, device) -> Any:
    if isinstance(obj, dict):
        if "__dataclass__" in obj:
            module, name = obj["__dataclass__"].split(":")
            if module.split(".")[0] != __name__.split(".")[0]:
                raise ValueError(f"a saved state names a class outside this package: {module}")
            cls = getattr(importlib.import_module(module), name)
            return cls(**{k: _decode(v, device) for k, v in obj.items() if k != "__dataclass__"})
        if "__generator__" in obj:  # on the device it draws on, where it was saved
            gen = torch.Generator(device=obj["__generator__"])
            gen.set_state(obj["state"].cpu())
            return gen
        return {k: _decode(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v, device) for v in obj)
    return obj


def save_params(path: str, state: Any) -> None:
    """Write a training loop's whole state (`train_loop.LoopState`: the
    master weights, the optimizer state, the step, the EMA and the
    generator's state) to `path` with torch.save."""
    torch.save(_encode(state), path)


def load_params(path: str, device=None) -> Any:
    """The state `save_params` wrote, its tensors on `device` (default:
    where they were saved), its generator where it was saved."""
    return _decode(torch.load(path, map_location=device, weights_only=True), device)
