"""Training step for the video denoiser (v-prediction diffusion loss): the
port of the JAX package's training.py.

Loss (the reference's p_losses with parameterization "v", l2):
  x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps
  v   = sqrt(acp_t) eps - sqrt(1 - acp_t) x0
  loss = mean((v_pred - v)^2)
t and eps are explicit tensors (`diffusion_loss`), or drawn by the step from
an explicit `torch.Generator`; the JAX package draws them from a key.

Mixed precision as flax runs it. The JAX UNet computes in bf16 while flax
keeps every parameter in float32 and casts it at each use. Here the train
state holds float32 master weights; the module holds the bf16 copy that
`cast_weights` makes (norm parameters and `float32_params` stay float32).
The step casts the module's gradients to float32 for the update and then
refreshes the module's copy from the master weights. Where the two can
differ: flax sums a reused weight's gradient across its uses after the cast,
in float32; here the uses accumulate into the bf16 parameter's gradient
first. In float32 (the CPU tests) the two are the same computation.

The step updates the train state in place (the master weights and the
optimizer state): the JAX step returns a new state, which at full width
would hold a second copy of every float32 tensor.

Under a mesh (`make_train_step(mesh=...)`, the JAX package's dp x sp step):
the batch is sharded over "dp" and its frames over "sp" (`shard_video_batch`),
context and fs over "dp"; the UNet runs with `frames` the sp axis, whose
gathers differentiate (`parallel/mesh.py`); each rank's loss is its sum of
squares over the global element count, so that the ranks' losses sum to the
global mean; the gradients are summed over every rank (one all_reduce of one
flat buffer), and every rank applies the same update. tp stays an inference
axis, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.profiler import record_function

from viewcrafter_tpu_torch.config import ModelConfig
from viewcrafter_tpu_torch.models.layers import cast_weights, init_random_
from viewcrafter_tpu_torch.models.unet3d import UNet3D
from viewcrafter_tpu_torch.ops.schedule import DiffusionSchedule
from viewcrafter_tpu_torch.parallel import mesh as pm


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]  # float32 master weights, by parameter name
    opt_state: Any
    step: int


@torch.no_grad()
def sync_model_(model: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy the master weights into the module's parameters (in their
    types: the bf16 copy, the float32 norms)."""
    for name, p in model.named_parameters():
        p.copy_(params[name])


def create_train_state(model: nn.Module, cfg: Any,
                       init: Union[torch.Generator, Dict[str, torch.Tensor]], tx) -> TrainState:
    """Initialise `model` (any of the port's models with a `cfg` and a
    `dtype`: UNet3D, Dust3rModel, CroCoPretrain) for training and return its
    state: the weights from `init`, a `torch.Generator` on the model's
    device (seeded random weights, `init_random_`) or a state dict (e.g.
    from `convert.from_jax_params`); float32 master copies of them; the
    module then cast to its dtype (`cast_weights`: the norms, and the
    modules that compute in float32, stay float32), its parameters requiring
    grad; the optimizer state of `tx`. `cfg`: the configuration the model
    was built from, checked against `model.cfg` (a ModelConfig stands for
    its UNet's)."""
    want = cfg.unet if isinstance(cfg, ModelConfig) else cfg
    if model.cfg != want:
        raise ValueError("the model was not built from this configuration")
    model.float()
    with torch.no_grad():
        if isinstance(init, torch.Generator):
            init_random_(model, init)
        else:
            model.load_state_dict(init, strict=True)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    cast_weights(model, model.dtype).train().requires_grad_(True)
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def diffusion_loss(model: UNet3D, sched: DiffusionSchedule, batch: dict, t: torch.Tensor,
                   eps: torch.Tensor, frames: pm.Axis = pm.NO_AXIS,
                   count: Optional[int] = None) -> torch.Tensor:
    """The v-prediction MSE of `model` on `batch` at timesteps t (B,) and
    noise eps (shaped like the latents). Batch: latents and cond_latents
    (B, T, h, w, 4), context (B, L, C), fs (B,) or absent. `frames`: the sp
    axis when the batch holds this rank's frames; `count`: the element count
    the sum of squares is divided by (default: this batch's)."""
    x0 = batch["latents"].float()
    sa = torch.as_tensor(sched.sqrt_alphas_cumprod, device=x0.device)[t].view(-1, 1, 1, 1, 1)
    sb = torch.as_tensor(sched.sqrt_one_minus_alphas_cumprod,
                         device=x0.device)[t].view(-1, 1, 1, 1, 1)
    x_t = sa * x0 + sb * eps
    v_target = sa * eps - sb * x0
    x_in = torch.cat([x_t, batch["cond_latents"].float()], dim=-1)
    v_pred = model(x_in, t.float(), batch["context"], fs=batch.get("fs"), frames=frames)
    err = (v_pred - v_target).square()
    return err.mean() if count is None else err.sum() / count


def make_train_step(model: UNet3D, sched: DiffusionSchedule, tx, mesh=None):
    """The train step: step(state, batch, generator=None, t=None, eps=None)
    -> (state, loss, grad_norm), with `state` updated in place, `loss` the
    global loss and `grad_norm` the float32 global norm of the gradients
    before clipping (0-dim tensors). t (B,) and eps, when not given, are
    drawn for the whole batch from `generator`, on its device. Batch dict:
    latents, cond_latents (B, T, h, w, 4), context (B, L, C), fs (B,), moved
    to the model's device. Under `mesh`, every rank passes the whole batch and the
    same draws and keeps its shard (module docstring)."""
    params = dict(model.named_parameters())
    dp = sp = pm.NO_AXIS
    group = None
    if mesh is not None:
        if pm.mesh_shape(mesh)["tp"] != 1:
            raise ValueError("the train step shards over dp and sp; tp is an inference axis")
        dp, sp = pm.axis(mesh, "dp"), pm.axis(mesh, "sp")
        group = dist.group.WORLD
    checked = []

    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None):
        device = next(model.parameters()).device
        batch = {k: v.to(device) for k, v in batch.items()}
        shape = batch["latents"].shape
        if t is None or eps is None:
            if generator is None:
                raise ValueError("pass t and eps, or a generator to draw them from")
            drawn_t = torch.randint(0, sched.num_timesteps, (shape[0],), generator=generator,
                                    device=generator.device)
            drawn_eps = torch.randn(shape, generator=generator, device=generator.device)
            t = drawn_t if t is None else t
            eps = drawn_eps if eps is None else eps
        t, eps = t.to(device), eps.to(device, torch.float32)
        if mesh is not None:
            if not checked:  # every rank must start from the same weights
                pm.assert_replicated(state.params.values())
                checked.append(True)
            local = {k: pm.shard_video_batch(v, mesh) if k in ("latents", "cond_latents")
                     else dp.local(v, 0) for k, v in batch.items()}
            batch, t, eps = local, dp.local(t, 0), pm.shard_video_batch(eps, mesh)
        with torch.enable_grad():
            with record_function("train_step.forward"):
                loss = diffusion_loss(model, sched, batch, t, eps, frames=sp,
                                      count=None if mesh is None else shape.numel())
            loss.backward()
        with record_function("train_step.optimizer"):
            grad_norm = apply_gradients_(model, params, state, tx, group)
            loss = loss.detach() if group is None else pm.all_reduce_sum(loss.detach(), group)
        state.step += 1
        return state, loss, grad_norm

    return step


def apply_gradients_(model: nn.Module, params: Dict[str, torch.nn.Parameter], state: TrainState,
                     tx, group=None) -> torch.Tensor:
    """The update half of a train step, after `loss.backward()`: the
    gradients of `params` (the module's, by name) as float32, zeros where a
    parameter got none, taken off the module; under a process `group`,
    summed over its ranks (one all_reduce of one flat buffer); then
    `tx.update_` of the master weights and the optimizer state in place,
    and the module's copy refreshed from them. Returns the global gradient
    norm before clipping."""
    grads = {}
    for name, p in params.items():
        grads[name] = (torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                       else p.grad.float())
        p.grad = None
    if group is not None:
        flat = pm.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads.values()]), group)
        offset = 0
        for g in grads.values():
            g.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()
        del flat
    grad_norm = tx.update_(state.params, grads, state.opt_state)
    del grads
    sync_model_(model, state.params)
    return grad_norm
