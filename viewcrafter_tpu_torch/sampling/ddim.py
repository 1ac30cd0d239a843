"""DDIM sampler for v-parameterized video latents: the port of the JAX
package's sampling/ddim.py (`GuidanceConfig`, `make_ddim_step`,
`ddim_sample`, `ddim_sample_window`, and `ddim_sample_window_pab`, which
also covers the JAX package's `ddim_sample_window_pab_cells`). The loops are
plain Python: nothing here is traced or compiled.

The K CFG branches ([uncond, cond], or [uncond, uncond_img, cond]) ride the
leading axis of one denoiser call. The per-step noise is an argument: the
caller passes `step_noise(i)`, a standard-normal tensor shaped like x, so
that a test can hand the sampler the same numbers the JAX package draws.
The per-step scalars are computed in float32 as the JAX package does.
Under frame sharding (`frame_axis`) x holds this rank's frames, and the CFG
rescale's statistics, which span the clip, are all-reduced over the axis.

Spans (`utils/profiling.py`, recorded only inside `profiling.recording()`):
each step is a `step` span (its index and kind: "step", "full" or "reuse")
holding `step.unet`, the denoiser call, and `step.update`, the CFG combine,
the rescale and the DDIM update; it closes before `on_step`. A full step of
the attention-reuse window counts the bytes of the cache it returned as
`reuse_cache_bytes`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from viewcrafter_tpu_torch.parallel.mesh import NO_AXIS, Axis
from viewcrafter_tpu_torch.ops.schedule import (
    DDIMSchedule,
    predict_eps_from_z_and_v,
    predict_start_from_z_and_v,
    rescale_noise_cfg,
)
from viewcrafter_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Classifier-free guidance knobs.

    sequential: evaluate the CFG branches one at a time instead of one
    batched denoiser call (lower peak memory, no shared-prefix dedup)."""

    scale: float = 7.5
    rescale: float = 0.7
    cfg_img: Optional[float] = None  # not None => multi-cond CFG (3 branches)
    sequential: bool = False

    @property
    def num_branches(self) -> int:
        if self.scale == 1.0:
            return 1
        return 3 if self.cfg_img is not None else 2


class StepParts(NamedTuple):
    """The pieces of one DDIM step, shared by the samplers below."""

    tile_k: Callable  # x (B, ...) -> the K CFG branches stacked, (K*B, ...)
    t_batch_at: Callable  # (i, device) -> step i's timestep as a (K*B,) tensor
    combine_cfg: Callable  # v of the K branches -> guided v, float32
    update: Callable  # (i, x, v, noise) -> x after step i


def ddim_step_parts(batch_size: int, schedule: DDIMSchedule,
                    guidance: GuidanceConfig = GuidanceConfig(),
                    frame_axis: Axis = NO_AXIS) -> StepParts:
    """frame_axis: the "sp" axis when x holds this rank's block of frames:
    the CFG rescale's statistics then span the whole clip."""
    b = batch_size
    k = guidance.num_branches
    f32 = np.float32
    use_rescale = schedule.scale_arr is not None

    def combine_cfg(v_all):
        v_all = v_all.float()
        if k == 1:
            return v_all
        if k == 2:
            v_uncond, v_cond = v_all.chunk(2, dim=0)
            v = v_uncond + guidance.scale * (v_cond - v_uncond)
        else:
            v_uncond, v_uncond_img, v_cond = v_all.chunk(3, dim=0)
            v = (v_uncond + guidance.cfg_img * (v_uncond_img - v_uncond)
                 + guidance.scale * (v_cond - v_uncond_img))
        if guidance.rescale > 0:
            v = rescale_noise_cfg(v, v_cond, guidance.rescale, frame_axis)
        return v

    def update(i, x, v, noise):
        sqrt_a = float(np.sqrt(schedule.alphas[i]))
        sqrt_1ma = float(schedule.sqrt_one_minus_alphas[i])
        e_t = predict_eps_from_z_and_v(x, v, sqrt_a, sqrt_1ma)
        pred_x0 = predict_start_from_z_and_v(x, v, sqrt_a, sqrt_1ma)
        if use_rescale:
            pred_x0 = pred_x0 * float(schedule.scale_arr_prev[i] / schedule.scale_arr[i])
        a_prev = schedule.alphas_prev[i]
        sigma = schedule.sigmas[i]
        dir_coef = np.sqrt(np.maximum(f32(1.0) - a_prev - sigma ** 2, f32(0.0)))
        dir_xt = float(dir_coef) * e_t
        return float(np.sqrt(a_prev)) * pred_x0 + dir_xt + float(sigma) * noise

    def tile_k(x):
        return x.repeat((k,) + (1,) * (x.ndim - 1))

    def t_batch_at(i, device):
        return torch.full((k * b,), float(schedule.timesteps[i]), dtype=torch.float32,
                          device=device)

    return StepParts(tile_k, t_batch_at, combine_cfg, update)


def make_ddim_step(denoise_fn: Callable, batch_size: int, schedule: DDIMSchedule,
                   guidance: GuidanceConfig = GuidanceConfig(), frame_axis: Axis = NO_AXIS):
    """Build step(i, x, noise) -> x for sampling-step index i (descending-t
    order); `noise` is a standard-normal tensor shaped like x."""
    parts = ddim_step_parts(batch_size, schedule, guidance, frame_axis)

    def step(i, x, noise):
        with profiling.span("step.unet"):
            v_all = denoise_fn(parts.tile_k(x), parts.t_batch_at(i, x.device))
        with profiling.span("step.update"):
            return parts.update(i, x, parts.combine_cfg(v_all), noise)

    return step


def ddim_sample(denoise_fn: Callable, x_T: torch.Tensor, schedule: DDIMSchedule,
                step_noise: Callable[[int], torch.Tensor],
                guidance: GuidanceConfig = GuidanceConfig(),
                on_step: Optional[Callable[[int], None]] = None) -> torch.Tensor:
    """Run the DDIM chain. denoise_fn(x_k, t) -> v, where x_k stacks the K
    guidance branches on the leading axis and t is (K*B,). step_noise(i)
    gives step i's standard-normal noise. on_step(i), if given, is called
    after each step (timing hooks). Returns pred x_0 latents (B, T, H, W, C)."""
    return ddim_sample_window(denoise_fn, x_T, schedule, step_noise, 0, schedule.num_steps,
                              guidance, on_step=(lambda i, _kind: on_step(i)) if on_step else None)


def ddim_sample_window(denoise_fn: Callable, x: torch.Tensor, schedule: DDIMSchedule,
                       step_noise: Callable[[int], torch.Tensor], start: int, num_steps: int,
                       guidance: GuidanceConfig = GuidanceConfig(),
                       on_step: Optional[Callable[[int, str], None]] = None,
                       frame_axis: Axis = NO_AXIS) -> torch.Tensor:
    """Run `num_steps` sampling steps beginning at step `start`: a slice of
    `ddim_sample`'s chain with the same step indices and noise.
    on_step(i, "step"), if given, is called after each step. frame_axis:
    see `ddim_step_parts`."""
    step = make_ddim_step(denoise_fn, x.shape[0], schedule, guidance, frame_axis)
    x = x.float()
    for i in range(start, start + num_steps):
        with profiling.span("step", step=i, kind="step"):
            x = step(i, x, step_noise(i))
        if on_step is not None:
            on_step(i, "step")
    return x


def ddim_sample_window_pab(denoise_full: Callable, denoise_reuse: Callable, x: torch.Tensor,
                           schedule: DDIMSchedule, step_noise: Callable[[int], torch.Tensor],
                           start: int, num_steps: int, interval: int,
                           guidance: GuidanceConfig = GuidanceConfig(),
                           on_step: Optional[Callable[[int, str], None]] = None,
                           frame_axis: Axis = NO_AXIS) -> torch.Tensor:
    """Attention-broadcast window (PAB, arXiv:2408.12588): the window is cut
    into cells of `interval` steps; the
    first step of each cell computes attention fully and collects the
    per-site outputs, the cell's other steps reuse them. A last cell may be
    short. One call does what the JAX package's
    `ddim_sample_window_pab_cells` plus its remainder call do.

    denoise_full(x_k, t) -> (v, cache); denoise_reuse(x_k, t, cache) -> v.
    on_step(i, "full" | "reuse"), if given, is called after each step."""
    parts = ddim_step_parts(x.shape[0], schedule, guidance, frame_axis)
    x = x.float()
    cache = None
    for j in range(num_steps):
        i = start + j
        kind = "full" if j % interval == 0 else "reuse"
        with profiling.span("step", step=i, kind=kind):
            with profiling.span("step.unet"):
                x_k, t_k = parts.tile_k(x), parts.t_batch_at(i, x.device)
                if kind == "full":
                    v_all, cache = denoise_full(x_k, t_k)
                    profiling.count_bytes("reuse_cache_bytes", cache)
                else:
                    v_all = denoise_reuse(x_k, t_k, cache)
            with profiling.span("step.update"):
                x = parts.update(i, x, parts.combine_cfg(v_all), step_noise(i))
        if on_step is not None:
            on_step(i, kind)
    return x
