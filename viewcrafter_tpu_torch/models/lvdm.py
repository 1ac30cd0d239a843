"""The latent video diffusion engine: guidance frames -> generated video.

The port of the JAX package's models/lvdm.py `VideoDiffusionEngine`:
  1. VAE-encode the guidance frames one frame at a time (posterior sample);
  2. CLIP-encode the condition frame (257 tokens) through the Resampler and
     CLIP-text-encode the prompts, giving the K CFG branch contexts;
  3. DDIM with v-prediction and batched (or sequential) CFG over UNet3D;
  4. VAE-decode the sampled latents one frame at a time.
`generate_staged` is the same pipeline with the sampling cut into windows
and, with `attn_reuse_interval` > 1, PAB-style attention reuse.

The engine runs on the card unless the caller asks for the CPU: with
`device=None` and no CUDA device it raises. Randomness comes from an explicit
`torch.Generator`, or from explicit noise tensors (`GenerateNoise`) so that
a test can feed the port the numbers the JAX package draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from viewcrafter_tpu_torch.config import ModelConfig
from viewcrafter_tpu_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder, clip_preprocess
from viewcrafter_tpu_torch.models.layers import cast_weights, init_random_
from viewcrafter_tpu_torch.models.resampler import Resampler
from viewcrafter_tpu_torch.models.unet3d import UNet3D
from viewcrafter_tpu_torch.models.vae import AutoencoderKL
from viewcrafter_tpu_torch.ops.schedule import DDIMSchedule, DiffusionSchedule
from viewcrafter_tpu_torch.sampling.ddim import (
    GuidanceConfig,
    ddim_sample_window,
    ddim_sample_window_pab,
)
from viewcrafter_tpu_torch.utils.tokenizer import tokenize

SUBMODELS = ("unet", "vae", "clip_text", "clip_vision", "resampler")
CACHE_DTYPES = {"bf16": None, "f8": torch.float8_e4m3fn}  # None: the module dtype


@dataclasses.dataclass
class GenerateNoise:
    """Every random draw of `generate`, as standard-normal tensors:
    x_T (B, T, h, w, z); steps (num_steps, B, T, h, w, z), one draw per DDIM
    step; posterior (B, T, h, w, z), the VAE posterior draw of each frame."""

    x_T: torch.Tensor
    steps: torch.Tensor
    posterior: torch.Tensor


def resolve_device(device=None) -> torch.device:
    """`None` means the card; without one that raises rather than running on
    the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


class VideoDiffusionEngine:
    """Owns the five submodels and the schedules.

    Two opt-in kernel routes, both off by default as in the JAX package
    (which reads environment variables for them; the port reads none):
    cross_attn_impl="auto" runs every image cross-attention of the UNet whose
    shape passes the gate as one `dual_cross_attention` call, and
    gn_fused=True runs every GroupNorm of the UNet and the VAE through
    `group_norm_fused`."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16, device=None,
                 cross_attn_impl: str = "xla", gn_fused: bool = False):
        self.cfg, self.dtype = cfg, dtype
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.unet = UNet3D(cfg.unet, dtype=dtype, cross_attn_impl=cross_attn_impl,
                               gn_fused=gn_fused)
            self.vae = AutoencoderKL(
                ch=cfg.vae.ch, ch_mult=cfg.vae.ch_mult, num_res_blocks=cfg.vae.num_res_blocks,
                embed_dim=cfg.vae.embed_dim, z_channels=cfg.vae.z_channels, dtype=dtype,
                gn_fused=gn_fused)
            self.clip_text = CLIPTextEncoder(cfg.clip_text, dtype=dtype)
            self.clip_vision = CLIPVisionEncoder(cfg.clip_vision, dtype=dtype)
            self.resampler = Resampler(cfg.resampler, dtype=dtype)
        for name in SUBMODELS:
            cast_weights(getattr(self, name), dtype).eval().requires_grad_(False)
        d = cfg.diffusion
        self.schedule = DiffusionSchedule.create(
            timesteps=d.timesteps, beta_schedule=d.beta_schedule,
            linear_start=d.linear_start, linear_end=d.linear_end,
            rescale_betas_zero_snr=d.rescale_betas_zero_snr,
            use_dynamic_rescale=d.use_dynamic_rescale, base_scale=d.base_scale,
            turning_step=d.turning_step,
        )
        self.scale_factor = d.scale_factor

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights in every parameter, none zero: weights of
        fan-in `f` ~ N(0, 1/f), biases ~ N(0, 0.02^2), norm scales
        1 + N(0, 0.05^2) and norm biases N(0, 0.05^2). Unlike the JAX
        package's init, the zero-initialised output layers get weights too,
        so every branch of the network contributes."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        for name in SUBMODELS:
            init_random_(getattr(self, name), g)

    @torch.no_grad()
    def load_params(self, state: dict) -> None:
        """Load {submodel: state_dict} (e.g. from `convert.from_jax_params`);
        strict, so every port parameter must be set and every entry used."""
        for name in SUBMODELS:
            getattr(self, name).load_state_dict(state[name], strict=True)

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode_frames(self, frames, posterior_noise=None):
        """Per-frame VAE encode: (B, T, H, W, 3) -> (B, T, h, w, z) * scale.
        posterior_noise (B, T, h, w, z): standard-normal draws of each frame's
        posterior sample; None takes the mode."""
        zs = []
        for t in range(frames.shape[1]):
            eps = None if posterior_noise is None else posterior_noise[:, t]
            zs.append(self.vae.encode(frames[:, t], eps))
        return torch.stack(zs, dim=1) * self.scale_factor

    @torch.no_grad()
    def decode_latents(self, z):
        """Per-frame VAE decode: (B, T, h, w, z) -> (B, T, H, W, 3)."""
        return torch.stack(
            [self.vae.decode(z[:, t] / self.scale_factor) for t in range(z.shape[1])], dim=1)

    @torch.no_grad()
    def image_context(self, image):
        """Condition image (B, H, W, 3) in [-1, 1] -> resampled tokens."""
        return self.resampler(self.clip_vision(clip_preprocess(image)))

    @torch.no_grad()
    def text_context(self, token_ids):
        return self.clip_text(token_ids)

    @torch.no_grad()
    def build_contexts(self, guidance_frames, cond_idx, token_ids, uncond_token_ids,
                       guidance: GuidanceConfig):
        """Per-branch cross-attention contexts stacked on a leading K axis, in
        the sampler's branch order [uncond, (uncond_img), cond]."""
        cond_frame = guidance_frames[:, cond_idx]
        img_ctx = self.image_context(cond_frame).float()
        zero_img_ctx = self.image_context(torch.zeros_like(cond_frame)).float()
        text_ctx = self.text_context(token_ids)
        uncond_text_ctx = self.text_context(uncond_token_ids)
        cond = torch.cat([text_ctx, img_ctx], dim=1)
        uncond = torch.cat([uncond_text_ctx, zero_img_ctx], dim=1)
        if guidance.num_branches == 1:
            return cond[None]
        if guidance.num_branches == 2:
            return torch.stack([uncond, cond])
        uncond_img = torch.cat([uncond_text_ctx, img_ctx], dim=1)
        return torch.stack([uncond, uncond_img, cond])

    def _denoise_fn(self, z_cond, contexts, fs_val: float, guidance: GuidanceConfig,
                    cache_kinds=("spatial", "cross", "temporal"), cache_sites: tuple = (),
                    cache_dtype: str = "bf16"):
        """Returns (denoise, denoise_full, denoise_reuse) over the K stacked
        CFG branches:
          denoise(x_k, t) -> v                          (baseline)
          denoise_full(x_k, t) -> (v, attention cache)   (PAB collect)
          denoise_reuse(x_k, t, cache) -> v              (PAB broadcast)
        Batched, the baseline is one UNet call with the shared-prefix dedup
        and the two cache programs run batched without it, as in the JAX
        package. Sequential (`guidance.sequential`), all three make one UNet
        call per branch, and the cache is a list of K dicts, each branch's
        own (the JAX package stacks them on a leading K axis under
        `lax.map`).

        cache_kinds: the site families cached. cache_sites: site-name
        prefixes (e.g. ("down_0", "up_0", "init_attn")): only matching sites
        stay in the cache, the rest are recomputed every step (a read miss
        falls through to the computation). cache_dtype: "bf16" stores the
        module dtype, "f8" torch.float8_e4m3fn."""
        k = guidance.num_branches
        b = z_cond.shape[0]
        store_dtype = CACHE_DTYPES[cache_dtype]
        fs_batch = torch.full((k * b,), fs_val, dtype=torch.float32, device=z_cond.device)

        def keep_sites(cache):
            if not cache_sites:
                return cache
            return {n: a for n, a in cache.items() if n.startswith(tuple(cache_sites))}

        if guidance.sequential and k > 1:
            fss = fs_batch.reshape(k, b)

            def per_branch(x_k, t_batch, caches=None, **kw):
                """One UNet call per branch j, with branch j's cache if given."""
                xs, ts = x_k.reshape((k, b) + x_k.shape[1:]), t_batch.reshape(k, b)
                outs = []
                for j in range(k):
                    if caches is not None:
                        kw["attn_cache"] = caches[j]
                    outs.append(self.unet(torch.cat([xs[j], z_cond], dim=-1), ts[j],
                                          contexts[j], fs=fss[j], **kw))
                return outs

            def denoise(x_k, t_batch):
                return torch.cat(per_branch(x_k, t_batch), dim=0)

            def denoise_full(x_k, t_batch):
                outs = per_branch(x_k, t_batch, collect_cache=True, cache_kinds=cache_kinds,
                                  cache_dtype=store_dtype)
                return torch.cat([v for v, _ in outs], dim=0), [keep_sites(c) for _, c in outs]

            def denoise_reuse(x_k, t_batch, caches):
                return torch.cat(per_branch(x_k, t_batch, caches, cache_kinds=cache_kinds),
                                 dim=0)

            return denoise, denoise_full, denoise_reuse

        ctx_flat = contexts.reshape((k * b,) + contexts.shape[2:])
        z_cond_k = z_cond.repeat((k,) + (1,) * (z_cond.ndim - 1))

        def denoise(x_k, t_batch):
            # shared_prefix=k: the sampler tiles one latent over the K CFG
            # branches, so the UNet computes the context-free prefix once
            return self.unet(torch.cat([x_k, z_cond_k], dim=-1), t_batch, ctx_flat,
                             fs=fs_batch, shared_prefix=k)

        def denoise_full(x_k, t_batch):
            v, cache = self.unet(torch.cat([x_k, z_cond_k], dim=-1), t_batch, ctx_flat,
                                 fs=fs_batch, collect_cache=True, cache_kinds=cache_kinds,
                                 cache_dtype=store_dtype)
            return v, keep_sites(cache)

        def denoise_reuse(x_k, t_batch, cache):
            return self.unet(torch.cat([x_k, z_cond_k], dim=-1), t_batch, ctx_flat,
                             fs=fs_batch, attn_cache=cache, cache_kinds=cache_kinds)

        return denoise, denoise_full, denoise_reuse

    def draw_noise(self, frames_shape, steps: int, generator: torch.Generator) -> GenerateNoise:
        """Standard-normal draws for one `generate` call on frames of
        `frames_shape` (B, T, H, W, 3), from `generator`."""
        b, t, hh, ww = frames_shape[:4]
        f = self.cfg.vae.downsample_factor
        shape = (b, t, hh // f, ww // f, self.cfg.vae.z_channels)

        def randn(*s):
            return torch.randn(s, generator=generator, device=self.device)

        return GenerateNoise(x_T=randn(*shape), steps=randn(steps, *shape),
                             posterior=randn(*shape))

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def _prepare(self, guidance_frames, token_ids, uncond_token_ids, dd: DDIMSchedule,
                 guidance: GuidanceConfig, cond_idx: int, noise: Optional[GenerateNoise],
                 generator: Optional[torch.Generator]):
        """The stage before sampling: the noise (drawn if not given), the
        guidance latents and the K branch contexts, all on the engine's
        device."""
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            noise = self.draw_noise(guidance_frames.shape, dd.num_steps, generator)
        frames = guidance_frames.to(self.device)
        z_cond = self.encode_frames(frames, noise.posterior.to(self.device))
        contexts = self.build_contexts(frames, cond_idx, token_ids.to(self.device),
                                       uncond_token_ids.to(self.device), guidance)
        return noise, z_cond, contexts

    @torch.no_grad()
    def generate(self, guidance_frames, token_ids, uncond_token_ids, steps: int = 50,
                 eta: float = 1.0, guidance: GuidanceConfig = GuidanceConfig(),
                 fs: Optional[int] = None, timestep_spacing: str = "uniform_trailing",
                 cond_idx: int = 0, noise: Optional[GenerateNoise] = None,
                 generator: Optional[torch.Generator] = None,
                 on_stage: Optional[Callable[[str], None]] = None):
        """guidance_frames (B, T, H, W, 3) in [-1, 1]; token ids (B, 77).
        Randomness from `noise` if given, else drawn from `generator` (a
        torch.Generator on the engine's device; one is seeded with 0 if
        neither is given). on_stage(name), if given, is called after
        "prepare", after each "step" and after "decode" (timing hooks).
        Returns the video (B, T, H, W, 3) in [-1, 1], float32."""
        return self.generate_staged(
            guidance_frames, token_ids, uncond_token_ids, steps=steps, eta=eta, guidance=guidance,
            fs=fs, timestep_spacing=timestep_spacing, cond_idx=cond_idx, chunk=max(steps, 1),
            noise=noise, generator=generator, on_stage=on_stage)

    @torch.no_grad()
    def generate_staged(self, guidance_frames, token_ids, uncond_token_ids, steps: int = 50,
                        eta: float = 1.0, guidance: GuidanceConfig = GuidanceConfig(),
                        fs: Optional[int] = None, timestep_spacing: str = "uniform_trailing",
                        cond_idx: int = 0, chunk: int = 10, attn_reuse_interval: int = 1,
                        attn_reuse_kinds: tuple = ("spatial", "cross", "temporal"),
                        attn_reuse_sites: tuple = (), attn_reuse_dtype: str = "bf16",
                        mesh=None, noise: Optional[GenerateNoise] = None,
                        generator: Optional[torch.Generator] = None,
                        on_stage: Optional[Callable[[str], None]] = None):
        """`generate` as prepare / sampling windows of `chunk` steps / decode;
        the windows change nothing: step indices and noise are the chain's.

        attn_reuse_interval > 1 enables Pyramid-Attention-Broadcast-style
        reuse (arXiv:2408.12588): every cell of that many steps computes
        attention once and broadcasts the outputs (the `attn_reuse_kinds`
        families at the `attn_reuse_sites` prefixes, stored as
        `attn_reuse_dtype`) to the cell's other steps; interval 1 is exact
        sampling. on_stage(name) is called after "prepare", after each
        sampling step ("step", or "full" / "reuse" under attention reuse) and
        after "decode". The sharded paths (`mesh`) are not ported yet."""
        if mesh is not None:
            raise NotImplementedError(
                "sharded generation (mesh, CFG-branch and tensor parallelism) is not ported "
                "yet (see ROADMAP.md)")
        if attn_reuse_interval > 1:
            # the JAX package caps a window near 24 steps for its serving
            # watchdog; on the card the cap bounds nothing, but the same
            # arithmetic keeps the cells where the JAX package puts them
            chunk = attn_reuse_interval * max(1, 24 // attn_reuse_interval)
        dd = DDIMSchedule.create(self.schedule, steps, eta=eta, timestep_spacing=timestep_spacing)
        noise, z_cond, contexts = self._prepare(guidance_frames, token_ids, uncond_token_ids, dd,
                                                guidance, cond_idx, noise, generator)
        fs_val = float(fs if fs is not None else self.cfg.unet.default_fs)
        denoise, denoise_full, denoise_reuse = self._denoise_fn(
            z_cond, contexts, fs_val, guidance, cache_kinds=attn_reuse_kinds,
            cache_sites=attn_reuse_sites, cache_dtype=attn_reuse_dtype)
        if on_stage is not None:
            on_stage("prepare")
        step_noise = noise.steps.to(self.device)
        on_step = (lambda i, kind: on_stage(kind)) if on_stage else None
        x = noise.x_T.to(self.device)
        s0 = 0
        while s0 < dd.num_steps:
            num = min(chunk, dd.num_steps - s0)
            if attn_reuse_interval > 1:
                x = ddim_sample_window_pab(denoise_full, denoise_reuse, x, dd,
                                           lambda i: step_noise[i], s0, num,
                                           attn_reuse_interval, guidance, on_step=on_step)
            else:
                x = ddim_sample_window(denoise, x, dd, lambda i: step_noise[i], s0, num,
                                       guidance, on_step=on_step)
            s0 += num
        video = self.decode_latents(x).float().clamp(-1.0, 1.0)
        if on_stage is not None:
            on_stage("decode")
        return video

    def prompt_ids(self, prompts, batch_size: int) -> torch.Tensor:
        if isinstance(prompts, str):
            prompts = [prompts] * batch_size
        return torch.from_numpy(tokenize(prompts)).to(torch.long).to(self.device)
