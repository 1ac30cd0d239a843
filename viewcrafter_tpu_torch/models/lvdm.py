"""The latent video diffusion engine: guidance frames -> generated video.

The port of the JAX package's models/lvdm.py `VideoDiffusionEngine`:
  1. VAE-encode the guidance frames one frame at a time (posterior sample);
  2. CLIP-encode the condition frame (257 tokens) through the Resampler and
     CLIP-text-encode the prompts, giving the K CFG branch contexts;
  3. DDIM with v-prediction and batched (or sequential) CFG over UNet3D;
  4. VAE-decode the sampled latents one frame at a time.
`generate_staged` is the same pipeline with the sampling cut into windows
and, with `attn_reuse_interval` > 1, PAB-style attention reuse, and with a
`mesh` sharded over several devices (samples or CFG branches over "dp",
frames over "sp", the UNet's heads and channels over "tp";
`parallel/mesh.py`, `parallel/tp.py`).

The engine runs on the card unless the caller asks for the CPU: with
`device=None` and no CUDA device it raises. Randomness comes from an explicit
`torch.Generator`, or from explicit noise tensors (`GenerateNoise`) so that
a test can feed the port the numbers the JAX package draws.
"""

from __future__ import annotations

import copy
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
from viewcrafter_tpu_torch.parallel.mesh import (
    NO_AXIS,
    Axis,
    axis,
    gather_video_batch,
)
from viewcrafter_tpu_torch.parallel.tp import shard_unet_
from viewcrafter_tpu_torch.sampling.ddim import (
    GuidanceConfig,
    ddim_sample_window,
    ddim_sample_window_pab,
)
from viewcrafter_tpu_torch.utils import profiling
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

    Two kernel routes, constructor arguments (the JAX package reads
    environment variables for them; the port reads none). gn_fused, on by
    default, runs every GroupNorm of the UNet and the VAE that the route's
    gate takes through `group_norm_fused` (`layers.GroupNorm32`);
    gn_fused=False gives the plain path. cross_attn_impl="auto", off by
    default as in the JAX package, runs every image cross-attention of the
    UNet whose shape passes the gate as one `dual_cross_attention` call.
    `UNet3D` and `AutoencoderKL` built directly, as `TrainLoop` builds its
    UNet, keep both routes off."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16, device=None,
                 cross_attn_impl: str = "xla", gn_fused: bool = True):
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
        self._tp_unet = None  # (tp axis, the UNet cut to that axis's slice)
        self.requests = 0  # `generate_staged` calls made: the running request number
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
        self._tp_unet = None
        for name in SUBMODELS:
            init_random_(getattr(self, name), g)

    @torch.no_grad()
    def load_params(self, state: dict) -> None:
        """Load {submodel: state_dict} (e.g. from `convert.from_jax_params`);
        strict, so every port parameter must be set and every entry used."""
        self._tp_unet = None
        for name in SUBMODELS:
            getattr(self, name).load_state_dict(state[name], strict=True)

    def unet_for(self, head_axis: Axis = NO_AXIS):
        """The UNet for a "tp" axis: the whole one at tp = 1, else a copy cut
        to this rank's heads and channels (`parallel/tp.py:shard_unet_`),
        made once per axis and dropped when the weights change. The whole
        UNet stays, for unsharded calls."""
        if head_axis.size == 1:
            return self.unet
        cached = self._tp_unet
        if cached is not None and cached[0] == head_axis:
            return cached[1]
        self._tp_unet = None  # free the old slice before the copy
        net = shard_unet_(copy.deepcopy(self.unet), head_axis)
        self._tp_unet = (head_axis, net)
        return net

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode_frames(self, frames, posterior_noise=None):
        """Per-frame VAE encode: (B, T, H, W, 3) -> (B, T, h, w, z) * scale.
        posterior_noise (B, T, h, w, z): standard-normal draws of each frame's
        posterior sample; None takes the mode. One image per call, so that a
        frame's latent does not depend on the batch it came in (a sharded
        run encodes other batches than a single-device one)."""
        zs = [[self.vae.encode(frames[i:i + 1, t], None if posterior_noise is None
                               else posterior_noise[i:i + 1, t])
               for t in range(frames.shape[1])] for i in range(frames.shape[0])]
        return torch.cat([torch.stack(z, dim=1) for z in zs]) * self.scale_factor

    @torch.no_grad()
    def decode_latents(self, z):
        """Per-frame VAE decode: (B, T, h, w, z) -> (B, T, H, W, 3), one
        image per call (see `encode_frames`)."""
        return torch.cat([torch.stack([self.vae.decode(z[i:i + 1, t] / self.scale_factor)
                                       for t in range(z.shape[1])], dim=1)
                          for i in range(z.shape[0])])

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
                    cache_dtype: str = "bf16", branch_axis: Axis = NO_AXIS,
                    frame_axis: Axis = NO_AXIS, head_axis: Axis = NO_AXIS):
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
        module dtype, "f8" torch.float8_e4m3fn.

        branch_axis: CFG-branch data parallelism for a batch that does not
        divide over "dp" (the JAX package's `branch_mesh`): this rank
        evaluates its block of the K*B branch rows, without the shared-prefix
        dedup (each rank computes its own rows' prefix), and v is gathered
        over the axis before the CFG combine, the path's one collective per
        step. Sequential CFG then runs this rank's rows B at a time, and the
        cache holds this rank's rows only. frame_axis: the "sp" axis when
        z_cond holds this rank's block of frames (UNet3D's `frames`).
        head_axis: the "tp" axis: the UNet calls go to this rank's slice of
        the UNet (`unet_for`), whose every split module all-reduces its
        output over the axis; the rows, the cache and the collectives above
        are as without it."""
        k = guidance.num_branches
        b = z_cond.shape[0]
        store_dtype = CACHE_DTYPES[cache_dtype]
        rows = branch_axis.block(k * b)
        n_rows = rows.stop - rows.start
        prefix = k if branch_axis.size == 1 else 1
        net = self.unet_for(head_axis)
        ctx_rows = contexts.reshape((k * b,) + contexts.shape[2:])[rows]
        z_rows = z_cond.repeat((k,) + (1,) * (z_cond.ndim - 1))[rows]
        fs_rows = torch.full((n_rows,), fs_val, dtype=torch.float32, device=z_cond.device)

        def keep_sites(cache):
            if not cache_sites:
                return cache
            return {n: a for n, a in cache.items() if n.startswith(tuple(cache_sites))}

        def unet(x_k, t_batch, part=slice(None), **kw):
            """The UNet on this rank's branch rows (`part` of them)."""
            x, t_b = x_k[rows][part], t_batch[rows][part]
            return net(torch.cat([x, z_rows[part]], dim=-1), t_b, ctx_rows[part],
                       fs=fs_rows[part], frames=frame_axis, **kw)

        def gather(v):
            return branch_axis.gather(v, 0)

        if guidance.sequential and k > 1:
            # unsharded, the K chunks of B rows are the K branches
            parts = [slice(s, s + b) for s in range(0, n_rows, b)]

            def per_part(x_k, t_batch, caches=None, **kw):
                """One UNet call per chunk j of B rows, with chunk j's cache
                if given."""
                outs = []
                for j, part in enumerate(parts):
                    if caches is not None:
                        kw["attn_cache"] = caches[j]
                    outs.append(unet(x_k, t_batch, part, **kw))
                return outs

            def denoise(x_k, t_batch):
                return gather(torch.cat(per_part(x_k, t_batch), dim=0))

            def denoise_full(x_k, t_batch):
                outs = per_part(x_k, t_batch, collect_cache=True, cache_kinds=cache_kinds,
                                cache_dtype=store_dtype)
                return (gather(torch.cat([v for v, _ in outs], dim=0)),
                        [keep_sites(c) for _, c in outs])

            def denoise_reuse(x_k, t_batch, caches):
                return gather(torch.cat(per_part(x_k, t_batch, caches, cache_kinds=cache_kinds),
                                        dim=0))

            return denoise, denoise_full, denoise_reuse

        def denoise(x_k, t_batch):
            # shared_prefix=k: the sampler tiles one latent over the K CFG
            # branches, so the UNet computes the context-free prefix once
            return gather(unet(x_k, t_batch, shared_prefix=prefix))

        def denoise_full(x_k, t_batch):
            v, cache = unet(x_k, t_batch, collect_cache=True, cache_kinds=cache_kinds,
                            cache_dtype=store_dtype)
            return gather(v), keep_sites(cache)

        def denoise_reuse(x_k, t_batch, cache):
            return gather(unet(x_k, t_batch, attn_cache=cache, cache_kinds=cache_kinds))

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
                 generator: Optional[torch.Generator], batch: slice = slice(None),
                 frame_block: slice = slice(None)):
        """The stage before sampling: the noise (drawn if not given), the
        guidance latents and the K branch contexts, all on the engine's
        device. batch / frame_block: this rank's block of the samples and
        frames under a mesh. The noise is drawn at the whole batch's shape
        and sliced, so that the chain's draws are the single-device ones; the
        contexts come from frame `cond_idx` of the whole clip, which every
        rank is given, so they need no collective."""
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            noise = self.draw_noise(guidance_frames.shape, dd.num_steps, generator)
        noise = GenerateNoise(x_T=noise.x_T[batch, frame_block],
                              steps=noise.steps[:, batch, frame_block],
                              posterior=noise.posterior[batch, frame_block])
        frames = guidance_frames[batch].to(self.device)
        with profiling.span("prepare.encode"):
            z_cond = self.encode_frames(frames[:, frame_block], noise.posterior.to(self.device))
        with profiling.span("prepare.contexts"):
            contexts = self.build_contexts(frames, cond_idx, token_ids[batch].to(self.device),
                                           uncond_token_ids[batch].to(self.device), guidance)
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
        after "decode".

        Spans (`utils/profiling.py`): the call is one `generate` span, the
        root, numbered by `self.requests`, holding `prepare` (with
        `prepare.encode` and `prepare.contexts`), the sampler's `step` spans
        and `decode`; each closes before the `on_stage` call after it.

        mesh: a ("dp", "sp", "tp") DeviceMesh (`parallel.mesh.make_mesh`),
        every rank calling with the same arguments (the whole batch, and the
        same `noise` or an equally seeded `generator`). Frames shard over
        "sp"; whole samples shard over "dp" when the batch divides, else (one
        sample on two devices) the K*B guidance-branch rows do (CFG-branch
        dp, `_denoise_fn`'s branch_axis). The UNet's heads and channels
        shard over "tp" (`parallel/tp.py`: the engine cuts its loaded UNet
        once per axis), inside each of those blocks. Each rank draws or takes
        the whole batch's noise and keeps its block, VAE-encodes and decodes
        its own frames and samples its block; the returned video is the whole
        batch on every rank, as the JAX package returns a global array.
        Needs frames % sp == 0, batch % dp == 0 or K*batch % dp == 0, and tp
        dividing the UNet's 32 GroupNorm groups."""
        self.requests += 1
        with profiling.span("generate", request=self.requests):
            b, t = guidance_frames.shape[:2]
            k = guidance.num_branches
            dp_axis, sp_axis, tp_axis = axis(mesh, "dp"), axis(mesh, "sp"), axis(mesh, "tp")
            if mesh is not None:
                dp, sp = dp_axis.size, sp_axis.size
                if t % sp or (b % dp and (k * b) % dp):
                    raise ValueError(
                        f"sharded generate needs frames {t} % sp {sp} == 0 and either batch {b} % "
                        f"dp {dp} == 0 (sample-dp) or branches*batch {k * b} % dp == 0 (CFG-dp)")
                self.unet_for(tp_axis)  # cut the UNet (or refuse the axis) before any work
            # CFG-branch dp: a batch that cannot shard over dp (e.g. ONE sample
            # on two devices) spreads its K tiled guidance branches over dp
            cfg_dp = b % dp_axis.size != 0
            batch = slice(None) if cfg_dp else dp_axis.block(b)
            if attn_reuse_interval > 1:
                # the JAX package caps a window near 24 steps for its serving
                # watchdog; on the card the cap bounds nothing, but the same
                # arithmetic keeps the cells where the JAX package puts them
                chunk = attn_reuse_interval * max(1, 24 // attn_reuse_interval)
            dd = DDIMSchedule.create(self.schedule, steps, eta=eta,
                                     timestep_spacing=timestep_spacing)
            with profiling.span("prepare"):
                noise, z_cond, contexts = self._prepare(
                    guidance_frames, token_ids, uncond_token_ids, dd, guidance, cond_idx, noise,
                    generator, batch, sp_axis.block(t))
                fs_val = float(fs if fs is not None else self.cfg.unet.default_fs)
                denoise, denoise_full, denoise_reuse = self._denoise_fn(
                    z_cond, contexts, fs_val, guidance, cache_kinds=attn_reuse_kinds,
                    cache_sites=attn_reuse_sites, cache_dtype=attn_reuse_dtype,
                    branch_axis=dp_axis if cfg_dp else NO_AXIS, frame_axis=sp_axis,
                    head_axis=tp_axis)
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
                                               attn_reuse_interval, guidance, on_step=on_step,
                                               frame_axis=sp_axis)
                else:
                    x = ddim_sample_window(denoise, x, dd, lambda i: step_noise[i], s0, num,
                                           guidance, on_step=on_step, frame_axis=sp_axis)
                s0 += num
            with profiling.span("decode"):
                video = self.decode_latents(x).float().clamp(-1.0, 1.0)
                # under CFG-branch dp every dp rank holds the whole batch
                video = sp_axis.gather(video, 1) if cfg_dp else gather_video_batch(video, mesh)
        if on_stage is not None:
            on_stage("decode")
        return video

    def prompt_ids(self, prompts, batch_size: int) -> torch.Tensor:
        if isinstance(prompts, str):
            prompts = [prompts] * batch_size
        return torch.from_numpy(tokenize(prompts)).to(torch.long).to(self.device)
