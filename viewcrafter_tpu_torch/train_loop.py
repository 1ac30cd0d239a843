"""Training loop: LR schedule, optimizer, EMA, save/resume, metric log; the
port of the JAX package's train_loop.py, wrapped around
`training.make_train_step`.

  - the optimizer is optax's `clip_by_global_norm(grad_clip)` followed by
    `adamw(schedule, weight_decay)`, written out by hand (`AdamW`) over the
    float32 master weights with `torch._foreach_*` ops, in groups of tensors
    so that its scratch stays small, updating them in place;
  - the schedules are optax's warmup-cosine, linear and constant ones, in
    float32 as jnp computes them;
  - the EMA shadow is updated after every step (utils/ema.py);
  - `save` writes the whole loop state (master weights, optimizer state,
    step, EMA, the generator's state) with `torch.save`
    (`utils.checkpoint.save_params`), so that a resumed run continues
    bit-identically on the CPU;
  - a jsonl log of {step, loss, lr, steps_per_s}.

The loop's randomness (seeded weights, then t and eps of every step) comes
from one `torch.Generator`, on the device the loop trains on. The loop runs
on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from viewcrafter_tpu_torch.config import ModelConfig
from viewcrafter_tpu_torch.models.layers import cast_weights
from viewcrafter_tpu_torch.models.lvdm import resolve_device
from viewcrafter_tpu_torch.models.unet3d import UNet3D
from viewcrafter_tpu_torch.ops.schedule import DiffusionSchedule
from viewcrafter_tpu_torch.training import (
    TrainState, create_train_state, make_train_step, sync_model_)
from viewcrafter_tpu_torch.utils.ema import EmaState, ema_init, ema_params, ema_update

GROUP = 64  # tensors per group of the optimizer's foreach update


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    lr: float = 1e-4  # base_learning_rate in the reference configs
    warmup_steps: int = 100
    decay_steps: int = 10_000
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    end_lr_ratio: float = 0.01
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    ema_decay: float = 0.9999  # LitEma default (lvdm/ema.py:8)
    use_ema: bool = True
    remat: bool = True  # per-block gradient checkpointing (reference parity)
    max_steps: int = 1000
    ckpt_dir: Optional[str] = None
    save_every: int = 500
    log_every: int = 50
    log_path: Optional[str] = None


# -- optax's schedules, in float32 -------------------------------------------

Schedule = Callable[[int], np.float32]


def constant_schedule(value: float) -> Schedule:
    return lambda count: np.float32(value)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `transition_steps`, constant
    `init_value` when that is not positive."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> np.float32:
        frac = np.float32(1) - np.float32(min(max(count, 0), transition_steps)) / np.float32(
            transition_steps)
        return np.float32(init_value - end_value) * frac + np.float32(end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule with exponent 1."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> np.float32:
        c = np.float32(min(float(count), float(decay_steps)))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * c
                                                           / np.float32(decay_steps)))
        return np.float32(init_value) * (np.float32(1 - alpha) * cosine + np.float32(alpha))

    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    """optax.join_schedules: each schedule counts from its boundary."""

    def schedule(count: int) -> np.float32:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)], [warmup_steps])


def make_lr_schedule(cfg: TrainLoopConfig) -> Schedule:
    peak = cfg.lr
    end = peak * cfg.end_lr_ratio
    if cfg.schedule == "cosine":
        return warmup_cosine_decay_schedule(
            0.0, peak, cfg.warmup_steps, max(cfg.decay_steps, cfg.warmup_steps + 1), end)
    if cfg.schedule == "linear":
        warm = linear_schedule(0.0, peak, cfg.warmup_steps)
        decay = linear_schedule(peak, end, max(cfg.decay_steps - cfg.warmup_steps, 1))
        return join_schedules([warm, decay], [cfg.warmup_steps])
    if cfg.schedule == "constant":
        return join_schedules(
            [linear_schedule(0.0, peak, cfg.warmup_steps), constant_schedule(peak)],
            [cfg.warmup_steps])
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


# -- the optimizer ----------------------------------------------------------


@dataclasses.dataclass
class AdamState:
    count: int  # updates made (optax's count; the schedule reads it before the increment)
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr_fn, b1, b2, eps,
    weight_decay=weight_decay)) over float32 parameters, in place.

    Clip: the global norm over every gradient; g * grad_clip / norm unless
    norm < grad_clip. Adam: mu = (1-b1) g + b1 mu, nu =
    (1-b2) g^2 + b2 nu, bias corrections 1 - b^count with the incremented
    count, update mu_hat / (sqrt(nu_hat) + eps); decay weight_decay * p
    added to every tensor (no mask); then times -lr_fn(count before the
    increment), added to the parameters."""

    def __init__(self, lr_fn: Schedule, grad_clip: float = 1.0,
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr_fn, self.grad_clip, self.weight_decay = lr_fn, grad_clip, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: AdamState) -> torch.Tensor:
        """One update of `params` and `state` in place from float32 `grads`
        (used as scratch: they hold the updates afterwards). Returns the
        global gradient norm before clipping."""
        names = list(params)
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([grads[k] for k in names])))
        clip = not float(norm) < self.grad_clip
        lr = float(self.lr_fn(state.count))
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        for i in range(0, len(names), GROUP):
            group = names[i:i + GROUP]
            p = [params[k] for k in group]
            g = [grads[k] for k in group]
            mu = [state.mu[k] for k in group]
            nu = [state.nu[k] for k in group]
            if clip:
                torch._foreach_div_(g, float(norm))
                torch._foreach_mul_(g, self.grad_clip)
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
            torch._foreach_copy_(g, mu)
            torch._foreach_div_(g, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(g, den)
            del den
            if self.weight_decay:
                torch._foreach_add_(g, p, alpha=self.weight_decay)
            torch._foreach_mul_(g, -lr)
            torch._foreach_add_(p, g)
        state.count = count
        return norm


def adamw(lr: float) -> AdamW:
    """optax.adamw(lr) with its defaults: a constant learning rate, no
    clip, weight decay 1e-4 (what the JAX package's pretraining tests
    train with)."""
    return AdamW(constant_schedule(lr), grad_clip=float("inf"), weight_decay=1e-4)


def make_optimizer(cfg: TrainLoopConfig) -> AdamW:
    return AdamW(make_lr_schedule(cfg), grad_clip=cfg.grad_clip, weight_decay=cfg.weight_decay)


# -- the loop ---------------------------------------------------------------


@dataclasses.dataclass
class LoopState:
    """Everything a resume needs."""

    train: TrainState
    ema: Optional[EmaState]
    generator: torch.Generator


class TrainLoop:
    """Drives `make_train_step` over a batch iterable with checkpointing.

    `loader` yields batch dicts (see `make_train_step`). The loop builds its
    UNet itself (`UNet3D(model_cfg.unet, dtype, remat=loop_cfg.remat)` on
    `device`, the card unless the caller asks for the CPU), or takes
    `model`; `unet_kw` goes to the UNet (the opt-in kernel routes). The state
    is updated in place."""

    def __init__(self, model_cfg: ModelConfig, loop_cfg: TrainLoopConfig, mesh=None,
                 model: Optional[UNet3D] = None, device=None,
                 dtype: torch.dtype = torch.bfloat16, **unet_kw):
        self.model_cfg, self.cfg, self.mesh = model_cfg, loop_cfg, mesh
        self.device = resolve_device(device)
        if model is None:
            with torch.device(self.device):
                model = UNet3D(model_cfg.unet, dtype=dtype, remat=loop_cfg.remat, **unet_kw)
        self.model = model
        d = model_cfg.diffusion
        self.sched = DiffusionSchedule.create(
            timesteps=d.timesteps, beta_schedule=d.beta_schedule, linear_start=d.linear_start,
            linear_end=d.linear_end, rescale_betas_zero_snr=d.rescale_betas_zero_snr)
        self.tx = make_optimizer(loop_cfg)
        self.lr_fn = make_lr_schedule(loop_cfg)
        self.step_fn = make_train_step(self.model, self.sched, self.tx, mesh=mesh)

    # -- state ---------------------------------------------------------------

    def init_state(self, generator: torch.Generator,
                   params: Optional[Dict[str, torch.Tensor]] = None) -> LoopState:
        """The weights `params` (a state dict), or seeded weights from
        `generator` (then on the loop's device); `generator` then draws
        every step's t and eps."""
        train = create_train_state(self.model, self.model_cfg,
                                   generator if params is None else params, self.tx)
        ema = ema_init(train.params) if self.cfg.use_ema else None
        return LoopState(train=train, ema=ema, generator=generator)

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(os.path.abspath(self.cfg.ckpt_dir), f"step_{step:08d}.pt")

    def save(self, state: LoopState, step: int) -> str:
        from viewcrafter_tpu_torch.utils.checkpoint import save_params

        path = self._ckpt_path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_params(path, state)
        return path

    def latest_checkpoint(self) -> Optional[str]:
        d = os.path.abspath(self.cfg.ckpt_dir) if self.cfg.ckpt_dir else None
        if not d or not os.path.isdir(d):
            return None
        steps = sorted(p for p in os.listdir(d) if p.startswith("step_"))
        return os.path.join(d, steps[-1]) if steps else None

    def restore(self, path: str) -> LoopState:
        """A LoopState saved by `save`, on the loop's device; the module's
        weights are set from its master weights."""
        from viewcrafter_tpu_torch.utils.checkpoint import load_params

        state = load_params(path, device=self.device)
        cast_weights(self.model, self.model.dtype).train().requires_grad_(True)
        sync_model_(self.model, state.train.params)
        return state

    # -- loop ----------------------------------------------------------------

    def run(self, loader: Iterable[dict], generator: torch.Generator,
            state: Optional[LoopState] = None, resume: bool = True,
            on_step: Optional[Callable] = None) -> LoopState:
        """Train up to `max_steps`: from `state`, else from the latest
        checkpoint (with `resume`), else from `init_state(generator)`.
        `on_step(step, loss, grad_norm)`, if given, is called after each step
        (and its EMA update)."""
        cfg = self.cfg
        if state is None:
            latest = self.latest_checkpoint() if resume else None
            state = self.restore(latest) if latest else self.init_state(generator)

        log_f = open(cfg.log_path, "a") if cfg.log_path else None
        t_last = time.time()
        step = state.train.step
        it = iter(loader)
        while step < cfg.max_steps:
            try:
                batch = next(it)
            except StopIteration:  # new epoch
                it = iter(loader)
                batch = next(it)
            _, loss, grad_norm = self.step_fn(state.train, batch, state.generator)
            if state.ema is not None:
                with record_function("train_loop.ema"):
                    ema_update(state.ema, state.train.params, cfg.ema_decay)
            step += 1
            if on_step is not None:
                on_step(step, loss, grad_norm)

            if cfg.log_every and step % cfg.log_every == 0:
                dt = time.time() - t_last
                rec = {"step": step, "loss": float(loss), "lr": float(self.lr_fn(step)),
                       "steps_per_s": round(cfg.log_every / max(dt, 1e-9), 3)}
                t_last = time.time()
                if log_f:
                    log_f.write(json.dumps(rec) + "\n")
                    log_f.flush()
                else:
                    print(json.dumps(rec))
            if cfg.ckpt_dir and cfg.save_every and step % cfg.save_every == 0:
                self.save(state, step)
        if cfg.ckpt_dir:
            self.save(state, step)
        if log_f:
            log_f.close()
        return state

    def eval_params(self, state: LoopState) -> Dict[str, torch.Tensor]:
        """Parameters to evaluate with: the EMA shadow when enabled (the
        reference's ema_scope), else the master weights."""
        return ema_params(state.ema) if state.ema is not None else state.train.params
