"""Device mesh and sharding helpers on torch.distributed: the counterpart of
the JAX package's parallel/mesh.py.

The JAX package runs one controller over an XLA mesh with axes
("dp", "sp", "tp"): XLA places every array's shards and inserts the
collectives. Here each device is driven by a process of its own (a rank,
started by torchrun or by `spawn`) that holds its shard of every array, and
the model code makes the collectives itself:
  - "dp": whole samples, or for a single sample its K CFG guidance branches
    (models/lvdm.py `generate_staged`);
  - "sp": video frames. Spatial stages treat frames as batch entries and stay
    local; each module that reads across frames (the temporal transformers
    and the temporal conv blocks) gathers the clip's frames over "sp", runs
    on all of them and keeps its own (models/unet3d.py);
  - "tp": tensor parallelism over the UNet's heads and channels: every rank
    builds the same whole weights, and the engine cuts its UNet to the
    rank's slice (`parallel/tp.py`); each split module all-reduces its
    row-parallel product over the axis (`Axis.sum`).
Every other parameter is replicated.

The process group comes from the torchrun environment (`init_distributed`)
with the backend its caller names: "nccl" for one card per rank, "gloo" on
the CPU or for ranks that share a card. gloo moves CUDA tensors through the
host; the collectives here stage them there explicitly.

Under grad mode the two collectives the model makes differentiate, with the
transposes of the JAX package's: the backward of `all_gather` is a
reduce-scatter (the sum of every rank's gradient of the gathered tensor, of
which each rank keeps its own block), the backward of `all_reduce_sum` is
`all_reduce_sum`. Both are staged through the host under gloo as the forward
is. A training step sums each rank's loss: rank r's gradient of the gathered
clip covers every rank's frames, and the sum over ranks is the whole loss's.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

AXES = ("dp", "sp", "tp")
BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str, device=None) -> int:
    """Join the process group of the torchrun environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE) over `backend`, "nccl" or "gloo"; with a
    CUDA `device`, make it this process's current card first. Returns this
    rank. A group that exists already must have the same backend."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
    elif backend == "nccl" and device is not None:
        # NCCL binds its communicator to this rank's card
        dist.init_process_group(backend, init_method="env://", device_id=torch.device(device))
    else:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(devices: Optional[Sequence] = None) -> torch.device:
    """This rank's device: `devices[rank]` where the caller names every
    rank's device (a card named twice is shared by two ranks), else one card
    per local rank, `cuda:LOCAL_RANK`, which raises when the machine has
    fewer cards than local ranks."""
    if devices is not None:
        if len(devices) != world_size():
            raise ValueError(f"{len(devices)} devices named for {world_size()} ranks")
        return torch.device(devices[rank()])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size())))
    cards = torch.cuda.device_count()
    if cards < local_world:
        raise RuntimeError(
            f"{local_world} ranks on this machine but {cards} CUDA devices: one card per rank, "
            "or name each rank's device (devices=...) to share a card")
    return torch.device("cuda", local_rank)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ("dp", "sp", "tp") DeviceMesh over the default process group, which
    must hold exactly `n_devices` ranks (default: all of them). The JAX
    package's factoring rule: dp = 2 when n / tp is even and > 1, sp the
    rest. Rank r sits at (r // (sp * tp), (r // tp) % sp, r % tp), as the
    JAX package reshapes its device list, so a tp group is tp consecutive
    ranks. A count that does not factor raises a ValueError, before the
    process group is looked at. `devices`: see `rank_device`; a CUDA device
    becomes this process's current card."""
    world = world_size()
    n = n_devices or world
    if tp < 1 or n % tp:
        raise ValueError(f"cannot factor {n} devices with tp={tp}")
    n_ds = n // tp
    if dp is None:
        dp = 2 if n_ds % 2 == 0 and n_ds > 1 else 1
    sp = n_ds // dp
    if dp * sp * tp != n:
        raise ValueError(f"cannot factor {n} devices into dp={dp} x sp={sp} x tp={tp}")
    if n != world:
        raise RuntimeError(
            f"a mesh of {n} devices needs a process group of {n} ranks, and this one has "
            f"{world}: start one process per device (torchrun --nproc_per_node {n}) and "
            "call parallel.init_distributed first")
    device = rank_device(devices)
    if device.type == "cuda":
        # the mesh picks a card itself unless the process has one already
        torch.cuda.set_device(device)
        torch.cuda.init()
    return DeviceMesh(device.type, torch.arange(n).reshape(dp, sp, tp), mesh_dim_names=AXES)


def mesh_shape(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def _staged(x: torch.Tensor, group) -> bool:
    """gloo carries CUDA tensors through the host: do that here, explicitly."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` of `group`, concatenated in rank order along `dim`
    (the list form of all_gather, which gloo and NCCL both carry). Under
    grad mode an `x` that requires grad gets the reduce-scatter as its
    backward."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, group, dim)
    return _all_gather(x, group, dim)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    src = x.detach().contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    if staged:
        parts = [p.to(x.device) for p in parts]
    return torch.cat(parts, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `x` of `group`, on every rank. Under grad mode
    an `x` that requires grad gets `all_reduce_sum` as its backward."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _all_reduce_sum(x, group)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    buf = x.detach().contiguous()
    staged = _staged(buf, group)
    buf = buf.cpu() if staged else buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device) if staged else buf


class _AllGather(torch.autograd.Function):
    """all_gather along `dim`; backward: reduce-scatter (the sum over the
    group's ranks, then this rank's block of `dim`)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce_sum(grad, ctx.group)
        index = dist.get_rank(ctx.group)
        return total.narrow(ctx.dim, index * ctx.n, ctx.n), None, None


class _AllReduceSum(torch.autograd.Function):
    """all_reduce_sum; backward: all_reduce_sum of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.group), None


def replicate(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's `x` on every rank (a broadcast over the default group); the
    other ranks' `x` gives only the shape, dtype and device."""
    if world_size() == 1:
        return x
    buf = x.detach().contiguous()
    staged = _staged(buf, None)
    if staged:
        buf = buf.cpu()
    dist.broadcast(buf, 0)
    return buf.to(x.device) if staged else buf


def assert_replicated(tensors) -> float:
    """Raise unless every rank holds the same `tensors` (weights built from
    one seed): one all_reduce of a float64 checksum, as its maximum and its
    negated minimum. Returns the checksum."""
    total = None
    for i, t in enumerate(tensors):
        part = t.detach().double().abs().sum() * (1.0 + 1e-3 * (i % 97))
        total = part if total is None else total + part.to(total.device)
    total = torch.zeros((), dtype=torch.float64) if total is None else total.cpu()
    both = torch.stack([total, -total])
    if world_size() > 1:
        if dist.get_backend() == "nccl":  # NCCL reduces device tensors only
            both = both.cuda()
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if float(both[0]) != -float(both[1]):
        raise AssertionError(f"ranks hold different weights: checksums from "
                             f"{-float(both[1])} to {float(both[0])}")
    return float(total)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the process group along it (None
    when it has one rank), its size and this rank's index on it."""

    group: Optional[dist.ProcessGroup] = None
    size: int = 1
    index: int = 0

    def block(self, n: int) -> slice:
        """This rank's block of an axis of length n (n % size == 0)."""
        m = n // self.size
        return slice(self.index * m, (self.index + 1) * m)

    def local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of `x` along `dim` (a view)."""
        b = self.block(x.shape[dim])
        return x.narrow(dim, b.start, b.stop - b.start)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather(x, self.group, dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(x, self.group)


NO_AXIS = Axis()


def axis(mesh: Optional[DeviceMesh], name: str) -> Axis:
    if mesh is None:
        return NO_AXIS
    size = mesh_shape(mesh)[name]
    if size == 1:
        return NO_AXIS
    return Axis(mesh.get_group(name), size, mesh.get_local_rank(name))


def shard_video_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's (dp, sp) block of a (B, T, ...) tensor: batch over dp,
    frames over sp."""
    return axis(mesh, "sp").local(axis(mesh, "dp").local(x, 0), 1)


def gather_video_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The inverse of `shard_video_batch`: the whole (B, T, ...) tensor on
    every rank."""
    return axis(mesh, "dp").gather(axis(mesh, "sp").gather(x, 1), 0)


# --------------------------------------------------------------------------
# local process groups (tests, the dry run, the smoke run)
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(fn, r: int, world: int, backend: str, port: int, devices, args, results) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
    try:
        init_distributed(backend, devices[r])
        results.put((r, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((r, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, devices: Sequence, args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run fn(*args) in `world` new processes (start method "spawn": the
    caller may hold a CUDA context) joined in one process group over
    localhost with `backend`; `devices[r]` is rank r's device (a CUDA one
    becomes its current card). fn must be importable and return picklable
    values (numpy rather than tensors), and the caller's main module must
    keep its work under `if __name__ == "__main__"`, since each rank imports
    it. Returns each rank's result in rank order. A rank that raises fails
    the call with its traceback, and the call fails when the ranks have not
    all finished after `timeout` seconds; either way every process is
    stopped."""
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices named for {world} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_run_rank, daemon=True,
                         args=(fn, r, world, backend, port, devices, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    done, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"ranks {sorted(set(range(world)) - set(done))} still running " \
                          f"after {timeout} s"
                break
            try:
                r, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in done]
                if dead:  # a rank that died without reporting (killed, out of memory)
                    time.sleep(1.0)  # its report may still be in the pipe
                    if results.empty():
                        failure = f"rank {dead[0]} exited with {procs[dead[0]].exitcode}"
                continue
            if ok:
                done[r] = value
            else:
                failure = f"rank {r} failed:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, world={world}): {failure}")
    return [done[r] for r in range(world)]
