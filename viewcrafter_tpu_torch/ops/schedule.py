"""Diffusion noise-schedule math: host-side numpy arrays plus torch helpers.

Behavioral spec mirrors the reference formulas:
  - beta schedules / zero-terminal-SNR rescale: lvdm/models/utils_diffusion.py:31-53,112-144
  - DDIM timestep discretization (incl. `uniform_trailing`): utils_diffusion.py:56-76
  - DDIM alphas/sigmas: utils_diffusion.py:79-91
  - dynamic-rescale scale_arr: lvdm/models/ddpm3d.py:522-527 and samplers/ddim.py:31-35
  - sinusoidal timestep embedding: utils_diffusion.py:8-28
  - CFG guidance rescale: utils_diffusion.py:147-158

All schedule construction happens in float64 numpy on the host exactly once per
sampler configuration (the same code as the JAX package's schedule, so the
arrays are equal bit for bit); the per-step math below works on torch tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from viewcrafter_tpu_torch.parallel.mesh import NO_AXIS, Axis


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedule in float64 (cf. lvdm/models/utils_diffusion.py:31-53)."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    elif schedule == "cosine":
        t = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(t / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shift/scale alphas_bar_sqrt so SNR(T)=0 (arXiv:2305.08891 Alg. 1;
    cf. lvdm/models/utils_diffusion.py:112-144)."""
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    abs_sqrt = np.sqrt(alphas_cumprod)
    abs_sqrt_0 = abs_sqrt[0].copy()
    abs_sqrt_T = abs_sqrt[-1].copy()
    abs_sqrt = abs_sqrt - abs_sqrt_T
    abs_sqrt = abs_sqrt * abs_sqrt_0 / (abs_sqrt_0 - abs_sqrt_T)
    alphas_bar = abs_sqrt**2
    alphas = alphas_bar[1:] / alphas_bar[:-1]
    alphas = np.concatenate([alphas_bar[0:1], alphas])
    return 1 - alphas


def make_ddim_timesteps(method: str, num_ddim_steps: int, num_ddpm_steps: int) -> np.ndarray:
    """DDIM sub-schedule of the DDPM timesteps (cf. utils_diffusion.py:56-76).

    `uniform_trailing` starts from the very last DDPM timestep (999), which the
    zero-terminal-SNR model requires.
    """
    if method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        steps = np.asarray(list(range(0, num_ddpm_steps, c))) + 1
    elif method == "uniform_trailing":
        c = num_ddpm_steps / num_ddim_steps
        steps = np.flip(np.round(np.arange(num_ddpm_steps, 0, -c))).astype(np.int64) - 1
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_steps * 0.8), num_ddim_steps) ** 2).astype(int) + 1
    else:
        raise ValueError(f"unknown ddim discretization {method!r}")
    return steps.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-DDPM-timestep arrays needed by q/p math (float32 numpy).

    Built once from the model config (cf. ddpm3d.py:123-186 register_schedule and
    :522-527 scale_arr).
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    scale_arr: np.ndarray | None  # dynamic-rescale factors indexed by DDPM t
    num_timesteps: int

    @staticmethod
    def create(
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 0.00085,
        linear_end: float = 0.012,
        rescale_betas_zero_snr: bool = True,
        use_dynamic_rescale: bool = True,
        base_scale: float = 0.3,
        turning_step: int = 400,
    ) -> "DiffusionSchedule":
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start, linear_end)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        scale_arr = None
        if use_dynamic_rescale:
            # linspace 1->base_scale over turning_step, then flat; length exceeds
            # `timesteps` on purpose (indexing only ever uses t < timesteps).
            scale_arr = np.concatenate(
                [np.linspace(1.0, base_scale, turning_step), np.full(timesteps, base_scale)]
            ).astype(np.float32)
        f32 = lambda x: np.asarray(x, dtype=np.float32)
        return DiffusionSchedule(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            scale_arr=scale_arr,
            num_timesteps=timesteps,
        )


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step arrays, ordered from t≈T down to t≈0 as the sampler visits
    them (index 0 = first sampling step = largest t). This differs from the
    reference, which stores ascending arrays and walks them backwards
    (samplers/ddim.py:136-205)."""

    timesteps: np.ndarray  # DDPM t per step, descending
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray
    scale_arr: np.ndarray | None  # dynamic-rescale at t
    scale_arr_prev: np.ndarray | None  # dynamic-rescale at prev t
    num_steps: int

    @staticmethod
    def create(
        sched: DiffusionSchedule,
        num_steps: int,
        eta: float = 1.0,
        timestep_spacing: str = "uniform_trailing",
    ) -> "DDIMSchedule":
        ts = make_ddim_timesteps(timestep_spacing, num_steps, sched.num_timesteps)
        acp = sched.alphas_cumprod.astype(np.float64)
        alphas = acp[ts]
        alphas_prev = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
        sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
        scale_arr = scale_arr_prev = None
        if sched.scale_arr is not None:
            scale_arr = sched.scale_arr[ts]
            # "fix a bug" variant of the reference (ddim.py:35): the prev scale of
            # the first (lowest-t) entry is scale_arr[0], not its own value.
            scale_arr_prev = np.concatenate([sched.scale_arr[0:1], scale_arr[:-1]])
        rev = lambda x: np.ascontiguousarray(np.flip(np.asarray(x, np.float32), axis=0))
        return DDIMSchedule(
            timesteps=np.ascontiguousarray(np.flip(ts)).astype(np.int32),
            alphas=rev(alphas),
            alphas_prev=rev(alphas_prev),
            sqrt_one_minus_alphas=rev(np.sqrt(1.0 - alphas)),
            sigmas=rev(sigmas),
            scale_arr=rev(scale_arr) if scale_arr is not None else None,
            scale_arr_prev=rev(scale_arr_prev) if scale_arr_prev is not None else None,
            num_steps=len(ts),
        )


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] layout (cf. utils_diffusion.py:8-28).

    t: (...,) float or int tensor -> (..., dim) float32.
    """
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float, frames: Axis = NO_AXIS) -> torch.Tensor:
    """Rescale CFG output std to the cond-branch std (arXiv:2305.08891 §3.4;
    cf. utils_diffusion.py:147-158). Reduces over all non-batch axes with the
    population std (ddof 0), as jnp.std does. frames: the "sp" axis when the
    tensors hold this rank's block of a (B, T, ...) clip's frames; the std
    then spans the whole clip (two all-reduced passes, mean then squares)."""
    axes = tuple(range(1, noise_pred_text.ndim))
    if frames.size == 1:
        std_text = torch.std(noise_pred_text.float(), dim=axes, keepdim=True, correction=0)
        std_cfg = torch.std(noise_cfg.float(), dim=axes, keepdim=True, correction=0)
    else:
        std_text, std_cfg = (_std_over_frames(a.float(), axes, frames)
                             for a in (noise_pred_text, noise_cfg))
    # guard a degenerate all-zero prediction (e.g. freshly-initialized model)
    rescaled = noise_cfg * (std_text / torch.clamp(std_cfg, min=1e-8))
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def _std_over_frames(x: torch.Tensor, axes: tuple, frames: Axis) -> torch.Tensor:
    n = x[0].numel() * frames.size
    mean = frames.sum(x.sum(dim=axes, keepdim=True, dtype=torch.float64)) / n
    sq = frames.sum((x.double() - mean).square().sum(dim=axes, keepdim=True))
    return (sq / n).sqrt().float()


def predict_eps_from_z_and_v(x_t, v, sqrt_acp_t, sqrt_1macp_t):
    """v-parameterization -> eps (cf. ddpm3d.py:247-252)."""
    return sqrt_acp_t * v + sqrt_1macp_t * x_t


def predict_start_from_z_and_v(x_t, v, sqrt_acp_t, sqrt_1macp_t):
    """v-parameterization -> x0 (cf. ddpm3d.py:239-245)."""
    return sqrt_acp_t * x_t - sqrt_1macp_t * v
