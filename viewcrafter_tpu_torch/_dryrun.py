"""Multi-device dry run of the port on the CPU:

    python -m viewcrafter_tpu_torch._dryrun N

The port of the inference half of the JAX package's `_dryrun.py`: N gloo
ranks on the CPU (`parallel.mesh.spawn`), each building `viewcrafter_tiny`
in float32 from one seed (checked equal on every rank with one all_reduce of
a checksum), run the sharded `generate_staged` (2 DDIM steps, K = 2 CFG),
and rank 0 holds each sharded video against its own single-device run at
the JAX package's bound, atol 2e-5:
  1. sample dp: batch = dp on `make_mesh(N)` (dp 2 x sp N/2 for an even N);
  2. CFG-branch dp: batch 1 on the same mesh, its K = 2 guidance branches
     over dp;
  3. frame sp alone: batch 1 on `make_mesh(N, dp=1)`, frames over all N
     ranks;
  4. tensor parallelism (N a multiple of 4): batch 1 on
     `make_mesh(N, dp=2, tp=2)`, the UNet's heads and channels over tp
     (`parallel/tp.py`) inside CFG-branch dp and, from N = 8, frame sp: the
     JAX dry run's dp x sp x tp check (dp 2 x tp 2 at N = 4, dp 2 x sp 2 x
     tp 2 at N = 8), in float64 (`TP_DTYPE`).
Frames are padded up to a multiple of the meshes' sp, as in the JAX dry run,
with at least two frames a rank. The ranks run MKL in its batch-invariant
mode (`batch_invariant_cpu`), and rank 0 computes the single-device run in
its own process with the same setting, so runs 1-3 match it to the bit.
Sharding over tp splits the UNet's sums (a row-parallel product is the sum
of the ranks' partial products), which no setting makes bit-equal to the
unsharded product; and in float32 this model's own rounding, amplified by
CFG over the steps, moves the video by about 3e-5 against a float64 run
(the inputs of run 2; tests/test_torch_tp.py holds it above ATOL). So run 4
builds its engines in float64 (the norms and softmax still compute in
float32 inside), where tp lands well within ATOL of the single-device run.

Then the collectives' backward on every rank (`check_collective_grads`) and
the JAX dry run's training step (`train_dryrun`): one dp x sp step of
`training.make_train_step` (`make_mesh(N)`: batch dp, frames over sp, at
least two frames a rank) on `viewcrafter_tiny` in float32 with seeded
weights, remat on (the training loop's default: the recompute gathers the
frames again and the gathers' backward is a reduce-scatter), held on every
rank against the single-device step in the same process: the loss and every
updated parameter within ATOL (the step's gradients are a sum over the ranks
in another order than the single device's, which float32 carries far below
ATOL).

Last, the pretraining steps over dp (`pretrain_dryrun`): a small DUSt3R
(linear head, the step symmetrized) and a small CroCo, each one step of
`pretrain.make_dust3r_train_step` / `make_croco_pretrain_step` at dp = N
(batch N, a sample a rank) against the single-device step: the loss within
rtol ATOL.

`generate_on_mesh` and `diffuse_on_mesh` are also the rank targets of
tests/test_torch_parallel.py, `train_on_mesh` of tests/test_torch_training.py,
`pretrain_on_mesh` of tests/test_torch_pretrain.py and of `chip_smoke.py`'s
pretrain_wiring phase.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from viewcrafter_tpu_torch.config import ModelConfig, get_model_config
from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, GenerateNoise, VideoDiffusionEngine
from viewcrafter_tpu_torch.parallel import mesh as pm
from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

ATOL = 2e-5  # the JAX dry run's bound, on the CPU
TP_DTYPE = torch.float64  # the engines of the tensor-parallel runs (module docstring)
STEPS = 2
SEED = 7
THREADS = 2  # torch threads a rank: the ranks share the machine's cores


@dataclasses.dataclass
class Run:
    """One sharded `generate_staged` of `generate_on_mesh`: inputs as numpy
    (frames, ids, uids; `noise` the three draws x_T, steps, posterior, or
    None to draw from a generator seeded with SEED), generate kwargs, the
    `make_mesh` kwargs, and the engines' dtype."""

    frames: np.ndarray
    ids: np.ndarray
    uids: np.ndarray
    noise: Optional[tuple]
    kwargs: dict
    mesh_kw: dict
    dtype: torch.dtype = torch.float32


def engine_on_rank(cfg: ModelConfig, state: Optional[dict],
                   dtype: torch.dtype = torch.float32) -> VideoDiffusionEngine:
    """The engine every rank builds, on the CPU in `dtype`: `state`
    ({submodel: {name: numpy}}) if given, else seeded weights; raises unless
    all ranks hold the same."""
    eng = VideoDiffusionEngine(cfg, dtype=dtype, device="cpu")
    if state is None:
        eng.init_params(seed=0)
    else:
        eng.load_params({n: {k: torch.from_numpy(v) for k, v in state[n].items()}
                         for n in SUBMODELS})
    pm.assert_replicated(p for n in SUBMODELS for p in getattr(eng, n).parameters())
    return eng


def batch_invariant_cpu() -> None:
    """Put MKL in its strict conditional-reproducibility mode, under which a
    product's rows do not depend on how many rows ride with it (MKL reads the
    setting at its first product, so call this before any). A sharded run
    computes smaller batches on each rank than the single-device run; with
    MKL's default kernels the two differ by up to 3.3e-5 after 2 steps of
    viewcrafter_tiny in float32 (rounding amplified by CFG), and with this
    they agree to the bit while each rank holds two frames or more (oneDNN
    convolves a batch of one image with another algorithm: at one frame per
    rank the gap was 2.1e-5). For rank processes (`generate_on_mesh`): it
    sets the process's environment."""
    os.environ["MKL_CBWR"] = "AVX2,STRICT"


def generate_on_mesh(cfg: ModelConfig, state: Optional[dict], runs: list) -> list:
    """Rank target: with batch-invariant kernels (`batch_invariant_cpu`),
    for each `Run` the engine of its dtype on the CPU (`engine_on_rank`, built once per dtype) and the sharded
    `generate_staged` on `make_mesh(**run.mesh_kw)` over CPU ranks. Returns
    [(video, single-device video or None)] as numpy: the single-device run,
    with the same weights and draws in the same process, on rank 0."""
    batch_invariant_cpu()
    torch.set_num_threads(THREADS)
    engines = {}
    out = []
    for spec in runs:
        if spec.dtype not in engines:
            engines[spec.dtype] = engine_on_rank(cfg, state, spec.dtype)
        eng, noise, frames = engines[spec.dtype], spec.noise, spec.frames
        mesh = pm.make_mesh(devices=["cpu"] * pm.world_size(), **spec.mesh_kw)
        args = [torch.from_numpy(a) for a in (frames, spec.ids, spec.uids)]

        def run(mesh):
            noise_t = None if noise is None else GenerateNoise(*map(torch.from_numpy, noise))
            return eng.generate_staged(*args, mesh=mesh, noise=noise_t,
                                       generator=torch.Generator().manual_seed(SEED),
                                       **spec.kwargs).numpy()

        video = run(mesh)
        if frames.shape[0] % pm.mesh_shape(mesh)["dp"] == 0:  # the helpers' round trip
            v = torch.from_numpy(video)
            if not torch.equal(pm.gather_video_batch(pm.shard_video_batch(v, mesh), mesh), v):
                raise AssertionError("gather_video_batch(shard_video_batch(x)) != x")
        out.append((video, run(None) if pm.rank() == 0 else None))
    return out


def diffuse_on_mesh(opts, state: dict, frames01, noise) -> tuple:
    """Rank target: `ViewCrafterPipeline.run_diffusion` on a pipeline of
    `opts` (mesh_devices = the world) on the CPU in float32 whose diffusion
    engine holds `state`; rank 0 hands in the guidance frames, the others
    None. `noise`: the three draws' numpy arrays of the sharded call, or
    None. Returns (video, the files in opts.save_dir)."""
    from viewcrafter_tpu_torch.pipeline import ViewCrafterPipeline

    batch_invariant_cpu()
    torch.set_num_threads(THREADS)
    pipe = ViewCrafterPipeline(opts, init_models=False, device="cpu", dtype=torch.float32)
    pipe.engine.load_params({n: {k: torch.from_numpy(v) for k, v in state[n].items()}
                             for n in SUBMODELS})
    if pm.rank() == 0:
        os.makedirs(opts.save_dir, exist_ok=True)
    noise_t = None if noise is None else GenerateNoise(*map(torch.from_numpy, noise))
    video = pipe.run_diffusion(frames01 if pm.rank() == 0 else None, noise=noise_t)
    files = sorted(os.listdir(opts.save_dir)) if os.path.isdir(opts.save_dir) else []
    return video, files


def dryrun_runs(n: int, cfg: ModelConfig):
    """(config with frames padded to every mesh's sp, the runs)."""
    dp = 2 if n % 2 == 0 and n > 1 else 1
    # a multiple of both meshes' sp, two frames a rank or more (batch_invariant_cpu)
    t = -(-max(cfg.video_length, 2 * n) // n) * n
    cfg = dataclasses.replace(cfg, video_length=t)
    rng = np.random.default_rng(SEED)

    def inputs(b):
        frames = rng.uniform(-1, 1, (b, t, cfg.height, cfg.width, 3)).astype(np.float32)
        ids = np.zeros((b, 77), np.int64)
        ids[:, :4] = [49406, 1000, 2000, 49407]
        return frames, ids, np.zeros((b, 77), np.int64)

    kwargs = dict(steps=STEPS, guidance=GuidanceConfig(scale=7.5), fs=10, chunk=1)
    runs = {"sample_dp": Run(*inputs(dp), None, kwargs, {}),
            "cfg_branch_dp": Run(*inputs(1), None, kwargs, {}),
            "frame_sp": Run(*inputs(1), None, kwargs, {"dp": 1})}
    if n % 4 == 0:
        runs["dp_sp_tp"] = Run(*inputs(1), None, kwargs, {"dp": 2, "tp": 2}, TP_DTYPE)
    return cfg, runs


def inference_dryrun(n: int, timeout: float = 600.0) -> dict:
    """The sharded runs on n gloo CPU ranks, each held against the
    single-device run at ATOL; returns {run: max abs error}."""
    cfg, runs = dryrun_runs(n, get_model_config("viewcrafter_tiny"))
    results = pm.spawn(generate_on_mesh, n, "gloo", devices=["cpu"] * n,
                       args=(cfg, None, list(runs.values())), timeout=timeout)
    errs = {}
    for j, name in enumerate(runs):
        got, ref = results[0][j]
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{name}: sharded video {got.shape}, finite "
                                 f"{np.isfinite(got).all()}")
        for r in range(1, n):
            if not np.array_equal(results[r][j][0], got):
                raise AssertionError(f"{name}: rank {r} returned another video than rank 0")
        errs[name] = float(np.abs(got - ref).max())
        if not errs[name] <= ATOL:
            raise AssertionError(f"{name}: sharded generation diverges from single-device: "
                                 f"max abs error {errs[name]} > {ATOL}")
    return errs


def train_batch(cfg: ModelConfig, b: int, t: int, seed: int = SEED) -> dict:
    """A seeded numpy training batch of `b` clips of `t` frames."""
    h, w = cfg.diffusion.latent_size
    ctx_len = cfg.clip_text.context_length + cfg.resampler.num_queries * (
        cfg.resampler.video_length or 1)
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((b, t, h, w, 4), np.float32),
            "cond_latents": rng.standard_normal((b, t, h, w, 4), np.float32),
            "context": rng.standard_normal((b, ctx_len, cfg.unet.context_dim), np.float32),
            "fs": np.full((b,), 10.0, np.float32)}


def train_step_once(cfg: ModelConfig, batch: dict, mesh=None) -> tuple:
    """One `make_train_step` step of a float32 UNet of `cfg` (remat on)
    with seeded weights and draws, on the CPU: (loss, grad norm, updated
    master weights as numpy)."""
    from viewcrafter_tpu_torch.models.unet3d import UNet3D
    from viewcrafter_tpu_torch.ops.schedule import DiffusionSchedule
    from viewcrafter_tpu_torch.train_loop import TrainLoopConfig, make_optimizer
    from viewcrafter_tpu_torch.training import create_train_state, make_train_step

    model = UNet3D(cfg.unet, dtype=torch.float32, remat=True)
    tx = make_optimizer(TrainLoopConfig(lr=1e-4, warmup_steps=0, schedule="constant"))
    state = create_train_state(model, cfg, torch.Generator().manual_seed(0), tx)
    step = make_train_step(model, DiffusionSchedule.create(timesteps=cfg.diffusion.timesteps),
                           tx, mesh=mesh)
    _, loss, norm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(SEED))
    return float(loss), float(norm), {k: v.numpy() for k, v in state.params.items()}


def train_dryrun(mesh) -> dict:
    """One sharded training step on `viewcrafter_tiny` over `mesh` (a
    ("dp", "sp", "tp") mesh with tp = 1): batch dp, frames a multiple of sp
    with two or more a rank. Raises unless the loss is finite and the loss
    and the updated weights are within ATOL of the single-device step (made
    in this process); returns the loss and both errors."""
    shape = pm.mesh_shape(mesh)
    dp, sp = shape["dp"], shape["sp"]
    cfg = get_model_config("viewcrafter_tiny")
    t = -(-max(cfg.video_length, 2 * sp) // sp) * sp
    batch = train_batch(cfg, dp, t)
    loss, norm, params = train_step_once(cfg, batch, mesh)
    ref_loss, ref_norm, ref = train_step_once(cfg, batch)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite training loss {loss}")
    err = max(float(np.abs(params[k] - ref[k]).max()) for k in ref)
    if not (abs(loss - ref_loss) <= ATOL and err <= ATOL):
        raise AssertionError(f"sharded train step diverges from single-device: loss {loss} "
                             f"against {ref_loss}, weights max abs error {err} > {ATOL}")
    return {"loss": loss, "loss_err": abs(loss - ref_loss), "weights_err": err}


def check_collective_grads() -> None:
    """The backward of the two collectives, on every rank of the default
    group: rank r's loss sum(w_r * all_gather(x_r)) gives x_r the gradient
    sum_q w_q at r's block (a reduce-scatter), and sum(w_r *
    all_reduce_sum(x_r)) gives it sum_q w_q; raises otherwise."""
    import torch.distributed as dist

    world, r = pm.world_size(), pm.rank()
    weights = [torch.arange(4 * world * 3, dtype=torch.float32).view(-1, 3) * (q + 1)
               for q in range(world)]
    total = sum(weights)
    x = torch.full((4, 3), float(r), requires_grad=True)
    (weights[r] * pm.all_gather(x, dist.group.WORLD, 0)).sum().backward()
    if not torch.equal(x.grad, total[4 * r:4 * (r + 1)]):
        raise AssertionError(f"rank {r}: all_gather's backward {x.grad} is not the reduce-scatter")
    y = torch.full((4 * world, 3), float(r), requires_grad=True)
    (weights[r] * pm.all_reduce_sum(y, dist.group.WORLD)).sum().backward()
    if not torch.equal(y.grad, total):
        raise AssertionError(f"rank {r}: all_reduce_sum's backward is not the sum")


def train_on_mesh(mesh_kw: dict) -> dict:
    """Rank target: `check_collective_grads`, then `train_dryrun` on
    make_mesh(**mesh_kw) over CPU ranks, with batch-invariant kernels.
    Returns its result and the mesh shape."""
    batch_invariant_cpu()
    torch.set_num_threads(THREADS)
    check_collective_grads()
    mesh = pm.make_mesh(devices=["cpu"] * pm.world_size(), **mesh_kw)
    return {**train_dryrun(mesh), "mesh": pm.mesh_shape(mesh)}


# -- the pretraining steps ---------------------------------------------------

PRETRAIN_LR = 1e-3


def pretrain_configs():
    """The small DUSt3R (linear head) and CroCo of the pretraining dry run
    and tests: 32x32 images, one or two blocks of 32 channels, 2 heads."""
    from viewcrafter_tpu_torch.config import Dust3rConfig
    from viewcrafter_tpu_torch.models.croco_pretrain import CroCoPretrainConfig

    small = dict(img_size=(32, 32), patch_size=16, enc_embed_dim=32, enc_depth=1,
                 enc_num_heads=2, dec_embed_dim=32, dec_num_heads=2)
    return {"dust3r": Dust3rConfig(**small, dec_depth=2, head_type="linear"),
            "croco": CroCoPretrainConfig(**small, dec_depth=1, mask_ratio=0.5)}


def pretrain_model(kind: str, cfg, device, dtype: torch.dtype = torch.float32):
    """A `Dust3rModel` ("dust3r") or `CroCoPretrain` ("croco") of `cfg` on
    `device`."""
    from viewcrafter_tpu_torch.models.croco_pretrain import CroCoPretrain
    from viewcrafter_tpu_torch.models.dust3r import Dust3rModel

    with torch.device(device):
        return (Dust3rModel if kind == "dust3r" else CroCoPretrain)(cfg, dtype=dtype)


def dust3r_view(h: int, w: int, seed: int) -> dict:
    """A seeded numpy view in the Co3dPairDataset layout (pose near the
    identity, points 2 in front of it, every pixel valid)."""
    r = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = r.standard_normal(3) * 0.1
    return {"img": (r.standard_normal((h, w, 3)) * 0.3).astype(np.float32),
            "pts3d": (r.standard_normal((h, w, 3)) + [0, 0, 2]).astype(np.float32),
            "valid_mask": np.ones((h, w), bool), "camera_pose": pose}


def pretrain_batch(kind: str, cfg, b: int, seed: int = SEED) -> dict:
    """A seeded numpy batch of `b` samples: two collated view dicts for
    DUSt3R, images and a mask (cfg.num_mask a row) for CroCo."""
    from viewcrafter_tpu_torch.models.croco_pretrain import random_mask

    h, w = cfg.img_size
    if kind == "dust3r":
        views = [dust3r_view(h, w, seed + i) for i in range(2 * b)]
        return {g: {k: np.stack([v[k] for v in views[j::2]]) for k in views[0]}
                for j, g in enumerate(("gt1", "gt2"))}
    rng = np.random.default_rng(seed)
    n = (h // cfg.patch_size) * (w // cfg.patch_size)
    return {"img1": (rng.standard_normal((b, h, w, 3)) * 0.3).astype(np.float32),
            "img2": (rng.standard_normal((b, h, w, 3)) * 0.3).astype(np.float32),
            "mask": random_mask(torch.Generator().manual_seed(seed), b, n,
                                cfg.num_mask(n)).numpy()}


def pretrain_steps(kind: str, cfg, weights: Optional[dict], batches: list, device="cpu",
                   dtype: torch.dtype = torch.float32, mesh=None, seed: int = 0) -> dict:
    """`len(batches)` steps of the DUSt3R step (symmetrized, mode plain) or
    the CroCo step from `weights` (a state dict; None: seeded from `seed`)
    with `train_loop.adamw(PRETRAIN_LR)`, on `device` in `dtype`, over `mesh` when
    given. Returns per step the loss and the gradient norm, and the final
    master weights (CPU tensors)."""
    from viewcrafter_tpu_torch.pretrain import make_croco_pretrain_step, make_dust3r_train_step
    from viewcrafter_tpu_torch.train_loop import adamw
    from viewcrafter_tpu_torch.training import create_train_state

    model = pretrain_model(kind, cfg, device, dtype)
    tx = adamw(PRETRAIN_LR)
    init = torch.Generator(device=device).manual_seed(seed) if weights is None else weights
    state = create_train_state(model, cfg, init, tx)
    if kind == "dust3r":
        step = make_dust3r_train_step(model, tx, mesh=mesh, symmetrized=True)
    else:
        step = make_croco_pretrain_step(model, tx, mesh=mesh)
    losses, norms = [], []
    for batch in batches:
        if kind == "dust3r":
            out = step(state, {g: {k: torch.as_tensor(v) for k, v in batch[g].items()}
                               for g in ("gt1", "gt2")})
        else:
            out = step(state, {k: torch.as_tensor(batch[k]) for k in ("img1", "img2")},
                       mask=torch.as_tensor(batch["mask"]))
        losses.append(float(out[1]))
        norms.append(float(out[-1]))
    return {"loss": losses, "grad_norm": norms,
            "params": {k: v.detach().float().cpu() for k, v in state.params.items()}}


def pretrain_on_mesh(spec: dict) -> dict:
    """Rank target: for each run of spec["runs"] (kind, cfg, weights as
    numpy, batches), `pretrain_steps` at dp = world on spec["devices"] (this
    rank's device) in spec["dtype"] (default float32). Returns the mesh and
    per run the losses, the gradient norms, the kernels' launches, backward
    passes and launch sites, and on rank 0 the final weights (numpy)."""
    from viewcrafter_tpu_torch.ops import kernels

    torch.set_num_threads(THREADS)
    if torch.device(spec["devices"][0]).type == "cpu":
        batch_invariant_cpu()
    else:  # float32 products in full precision, as in the single-rank run
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = pm.make_mesh(dp=pm.world_size(), devices=spec["devices"])
    device = pm.rank_device(spec["devices"])
    out = []
    for run in spec["runs"]:
        weights = {k: torch.from_numpy(v) for k, v in run["weights"].items()}
        kernels.reset_launches()
        res = pretrain_steps(run["kind"], run["cfg"], weights, run["batches"], device,
                             spec.get("dtype", torch.float32), mesh)
        out.append({"kind": run["kind"], "loss": res["loss"], "grad_norm": res["grad_norm"],
                    "launches": kernels.launch_counts(),
                    "backward_plain": kernels.backward_plain_counts(),
                    "sites": kernels.launch_sites(),
                    "params": ({k: v.numpy() for k, v in res["params"].items()}
                               if pm.rank() == 0 else None)})
    return {"rank": pm.rank(), "mesh": pm.mesh_shape(mesh), "runs": out}


def seeded_weights(kind: str, cfg, seed: int = SEED) -> dict:
    """Seeded float32 weights of the pretraining model of `kind` at `cfg`,
    on the CPU (`init_random_`)."""
    from viewcrafter_tpu_torch.models.layers import init_random_

    model = pretrain_model(kind, cfg, "cpu")
    init_random_(model, torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def pretrain_dryrun(world: int = 2, timeout: float = 300.0) -> dict:
    """One DUSt3R and one CroCo step at dp = `world` on gloo CPU ranks (one
    spawn) against the single-device step in this process: raises unless
    each loss is within rtol ATOL; returns the relative errors."""
    runs = [{"kind": kind, "cfg": cfg, "batches": [pretrain_batch(kind, cfg, world)],
             "weights": {k: v.numpy() for k, v in seeded_weights(kind, cfg).items()}}
            for kind, cfg in pretrain_configs().items()]
    ranks = pm.spawn(pretrain_on_mesh, world, "gloo", devices=["cpu"] * world,
                     args=({"runs": runs, "devices": ["cpu"] * world},), timeout=timeout)
    batch_invariant_cpu()
    errs = {}
    for i, run in enumerate(runs):
        ref = pretrain_steps(run["kind"], run["cfg"],
                             {k: torch.from_numpy(v) for k, v in run["weights"].items()},
                             run["batches"])
        got = [r["runs"][i]["loss"] for r in ranks]
        if any(g != got[0] for g in got):
            raise AssertionError(f"{run['kind']}: the ranks report other losses: {got}")
        errs[run["kind"]] = abs(got[0][0] - ref["loss"][0]) / abs(ref["loss"][0])
        if not errs[run["kind"]] <= ATOL:
            raise AssertionError(f"{run['kind']}: dp {world} loss {got[0][0]} against "
                                 f"{ref['loss'][0]} single-device (rtol {ATOL})")
    return errs


def main(n: int) -> None:
    errs = inference_dryrun(n)
    print(f"sharded inference ok on {n} gloo CPU ranks (sample dp, CFG-branch dp, frame "
          f"sp{' and dp x sp x tp' if n % 4 == 0 else ''} against single-device, atol {ATOL}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
    ranks = pm.spawn(train_on_mesh, n, "gloo", devices=["cpu"] * n, args=({},), timeout=600)
    res = ranks[0]
    print(f"sharded train step ok on {n} gloo CPU ranks (mesh {res['mesh']}, loss "
          f"{res['loss']:.6g}; against single-device, atol {ATOL}: loss {res['loss_err']:.3g}, "
          f"weights {res['weights_err']:.3g})", flush=True)
    errs = pretrain_dryrun(n)
    print(f"sharded pretraining steps ok at dp {n} on gloo CPU ranks (against single-device, "
          f"rtol {ATOL}): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
