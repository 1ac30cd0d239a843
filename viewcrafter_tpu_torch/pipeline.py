"""ViewCrafter pipeline: photos -> point cloud -> rendered trajectory ->
diffused novel-view video, on the card.

The port of the JAX package's `pipeline.py`, mode for mode (the reference's
viewcrafter.py:108-382), with the same artifacts (render*.mp4, diffusion*.mp4,
pcd*.ply, scene0.ply, viz_traj.mp4, candidate_mask*.png):
  - single_view_target / single_view_txt: one photo, one trajectory;
  - sparse_view_interp: a B-spline path through N >= 2 photos, one
    diffusion call per segment between two photos;
  - single_view_eval: the trajectory of a clip recovered by DUSt3R, the
    first frame's cloud rendered along it;
  - single_view_ref_iterative, single_view_1drc_iterative and
    single_view_nbv: every 6th generated frame joins the views, DUSt3R and
    the alignment run again, and the next trajectory starts there (nbv picks
    it among candidates by least coverage).
Each pass runs
  1. DUSt3R pointmaps: each unique image encoded once, the decoder and heads
     run per directed pair (`run_dust3r`);
  2. global alignment: MST init on the host, `niter` Adam steps on the
     device (`align/global_align.py`);
  3. the point cloud rasterized along the trajectory (`run_render`), then
     upsampled to the diffusion resolution;
  4. `VideoDiffusionEngine.generate_staged` with the engine's default
     routes, the fused GroupNorm on (`run_diffusion`).

Everything runs on the pipeline's device: with `device=None` that is the
card, and without one the pipeline raises; the CPU only when asked for.

Multi-device sampling (`mesh_devices` > 1): one process per device in a
process group of exactly that many ranks (torchrun; `parallel/mesh.py`), each
building the same pipeline. Rank 0 runs the mode: DUSt3R, the alignment, the
render and every artifact write; before each diffusion call it broadcasts the
guidance frames, and every rank takes part in the sharded `generate_staged`
(`run_diffusion`). The other ranks wait in `run()` for those calls. Where the
JAX package falls back to its serial loop because the host has fewer devices
than `mesh_devices`, the port raises: that fallback would draw other noise
than the sharded run. With `mesh_tp` > 1 the UNet's heads and channels
shard over that many ranks of the mesh (`parallel/tp.py`). The
released checkpoints load where `ckpt_path` / `model_path` exist
(`setup_models`, through `utils/checkpoint.py`); without them the models hold
seeded random weights, as the JAX package's dev mode does. With a loaded
diffusion checkpoint the prompt needs the CLIP BPE merges file: the
tokenizer's hash fallback would corrupt the text conditioning, so it raises.

Unlike the JAX package, which pads the encoder batch to 8 images and the
pair batch to `batch_size` to keep its compiled programs static, the port
runs only the real images and pairs; the results are the same. And where
the JAX package keeps the elevation its previous `run()` left (the
iterative and nbv modes lower it), the port starts every run from
`opts.elevation`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from viewcrafter_tpu_torch.align.global_align import AlignedScene, GlobalAligner, SceneGraph
from viewcrafter_tpu_torch.align.pairs import make_pairs
from viewcrafter_tpu_torch.config import (
    AlignConfig,
    Dust3rConfig,
    ModelConfig,
    get_dust3r_config,
    get_model_config,
)
from viewcrafter_tpu_torch.geometry import trajectory as traj
from viewcrafter_tpu_torch.geometry.transforms import (
    as_f32,
    inv_se3,
    make_intrinsics,
    world_point_to_kth,
    world_point_to_obj,
)
from viewcrafter_tpu_torch.models.dust3r import Dust3rModel
from viewcrafter_tpu_torch.models.layers import init_random_
from viewcrafter_tpu_torch.models.lvdm import (
    SUBMODELS,
    GenerateNoise,
    VideoDiffusionEngine,
    resolve_device,
)
from viewcrafter_tpu_torch.ops.rasterize import render_trajectory
from viewcrafter_tpu_torch.ops.resize import resize_bilinear
from viewcrafter_tpu_torch.parallel import mesh as pm
from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig
from viewcrafter_tpu_torch.utils import checkpoint as ck
from viewcrafter_tpu_torch.utils import io as vio
from viewcrafter_tpu_torch.utils.tokenizer import tokenize

MULTI_VIEW_MODES = ("sparse_view_interp", "single_view_eval")
ITERATIVE_SAMPLE_RATE = 6  # every 6th generated frame joins the views (viewcrafter.py:311-382)


@dataclasses.dataclass
class InferenceOptions:
    """Runtime flags, mirroring configs/infer_config.py:4-59 (the JAX
    package's own copy, field for field)."""

    image_dir: str = "test/images/fruit.png"
    out_dir: str = "./output"
    exp_name: Optional[str] = None
    mode: str = "single_view_txt"
    traj_txt: Optional[str] = None
    elevation: float = 5.0
    center_scale: float = 1.0
    d_theta: Sequence[float] = (10.0,)
    d_phi: Sequence[float] = (30.0,)
    d_r: Sequence[float] = (-0.2,)
    d_x: Sequence[float] = (0.0,)
    d_y: Sequence[float] = (0.0,)
    mask_image: bool = False
    mask_pc: bool = True
    reduce_pc: bool = False
    bg_trd: float = 0.0
    dpt_trd: float = 1.0
    # diffusion
    model: str = "viewcrafter_25"
    ckpt_path: Optional[str] = None
    ddim_steps: int = 50
    ddim_eta: float = 1.0
    height: int = 576
    width: int = 1024
    frame_stride: int = 10
    unconditional_guidance_scale: float = 7.5
    seed: int = 123
    video_length: int = 25
    prompt: str = "Rotating view of a scene"
    text_input: bool = True  # False -> empty prompt (diffusion_utils.py:124)
    multiple_cond_cfg: bool = False
    cfg_img: Optional[float] = None
    timestep_spacing: str = "uniform_trailing"
    guidance_rescale: float = 0.7
    n_samples: int = 1
    # memory / speed knobs (no reference equivalent)
    sequential_cfg: bool = False
    attn_reuse_interval: int = 1  # >1: PAB attention reuse (arXiv:2408.12588); 1 = exact
    attn_reuse_sites: tuple = ()
    attn_reuse_kinds: tuple = ("spatial", "cross", "temporal")
    attn_reuse_dtype: str = "bf16"  # cache storage: "bf16" | "f8"
    mesh_devices: int = 0  # >1: multi-device sampling over that many ranks
    mesh_tp: int = 1  # >1: tensor-parallel UNet heads/channels (parallel/tp.py)
    # dust3r
    model_path: Optional[str] = None
    batch_size: int = 8  # pairs per decoder call
    niter: int = 300
    lr: float = 0.01
    schedule: str = "linear"
    min_conf_thr: float = 3.0
    dust3r_size: int = 512
    dust3r_model: str = "dust3r_512"  # architecture preset (config.DUST3R_REGISTRY)
    weights_dtype: str = "bf16"  # "bf16": every weight rounded to bf16, as the JAX package stores them

    @property
    def save_dir(self) -> str:
        name = self.exp_name
        if name is None:
            name = os.path.splitext(os.path.basename(self.image_dir.rstrip("/")))[0]
        return os.path.join(self.out_dir, name)


@torch.no_grad()
def round_to_bf16_(module: torch.nn.Module) -> None:
    """Round every floating parameter to a bf16 value in place (its storage
    type unchanged): the JAX package's bf16 weight storage, under which its
    float32 layers (norms, the DPT heads) compute with bf16-valued weights."""
    for p in module.parameters():
        if p.is_floating_point():
            p.copy_(p.to(torch.bfloat16).to(p.dtype))


class ViewCrafterPipeline:
    """Owns both model stacks and runs every mode.

    dtype: the networks' compute type (DUSt3R's encoder and decoder, the
    diffusion engine), bf16 as in the JAX package; alignment and rendering
    are float32 either way.

    on_stage(name), if given, is called after each stage of every pass,
    segment and iteration: "dust3r_encode", "dust3r_decode", "align_init"
    (the MST init, on the host), "align" (the Adam steps, the scene and the
    cleaning of the cloud), "render" (the rasterizer: the NBV candidates,
    then the trajectory), "write_render" (the upsample, the render video and
    the PLY files), then per diffusion call the engine's "prepare", one
    "step" per DDIM step and "decode", and "write_video" (the diffusion
    video). Timing hooks; the caller synchronizes.

    nbv_passes: the passes of single_view_nbv, 3 as in the reference; fewer
    stop the mode early (a shorter run of the same path).

    With opts.mesh_devices > 1 the process group must hold that many ranks
    (`parallel.mesh.init_distributed`), and `device` is this rank's device
    (default: one card per local rank)."""

    def __init__(self, opts: InferenceOptions, init_models: bool = True, device=None,
                 model_cfg: Optional[ModelConfig] = None,
                 dust3r_cfg: Optional[Dust3rConfig] = None,
                 on_stage: Optional[Callable[[str], None]] = None,
                 dtype: torch.dtype = torch.bfloat16, nbv_passes: int = 3):
        self.rank, self.world = 0, 1
        self.nbv_passes = nbv_passes
        if opts.mesh_devices > 1:
            world = pm.world_size()
            if world != opts.mesh_devices:
                raise RuntimeError(
                    f"mesh_devices={opts.mesh_devices} needs a process group of "
                    f"{opts.mesh_devices} ranks, and this process has {world}: run "
                    f"`torchrun --nproc_per_node {opts.mesh_devices} -m viewcrafter_tpu_torch.cli "
                    f"... --mesh_devices {opts.mesh_devices}`")
            self.rank, self.world = pm.rank(), world
            if device is None:
                device = pm.rank_device()
        self._mesh = None
        self.opts = opts
        self.device = resolve_device(device)
        self.model_cfg: ModelConfig = model_cfg or get_model_config(opts.model)
        self.dust3r_cfg = dust3r_cfg or get_dust3r_config(opts.dust3r_model)
        self.align_cfg = AlignConfig(niter=opts.niter, lr=opts.lr, schedule=opts.schedule,
                                     min_conf_thr=opts.min_conf_thr)
        self.on_stage = on_stage
        self.generator = torch.Generator(device=self.device).manual_seed(opts.seed)
        # the engine's default routes: the fused GroupNorm, the plain cross-attention
        self.engine = VideoDiffusionEngine(self.model_cfg, dtype=dtype, device=self.device)
        with torch.device(self.device):
            self.dust3r = Dust3rModel(self.dust3r_cfg, dtype=dtype)
        self.dust3r.eval().requires_grad_(False)
        self.loaded_real_ckpt = False
        if init_models:
            self.setup_models()
        # state per run
        self.images: List[vio.LoadedImage] = []
        self.img_gts: List[np.ndarray] = []
        self.scene: Optional[AlignedScene] = None
        self.guidance_frames: Optional[np.ndarray] = None  # the last render, upsampled
        self.elevation = opts.elevation
        self._noise: Optional[List[GenerateNoise]] = None  # explicit draws left for this run

    def _stage(self, name: str) -> None:
        if self.on_stage is not None:
            self.on_stage(name)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def setup_models(self) -> None:
        """The released checkpoints where their paths exist, as the JAX
        package's `setup_models` loads them: each file translated to the
        port's names, its shapes checked and loaded strictly
        (`utils/checkpoint.py`); else seeded random weights (the dev mode:
        outputs are untrained noise). Then the bf16 storage rounding."""
        g = torch.Generator(device=self.device).manual_seed(self.opts.seed)
        if self.opts.model_path and os.path.exists(self.opts.model_path):
            raw = ck.load_torch_file(self.opts.model_path)
            shapes = {k: v.shape for k, v in self.dust3r.state_dict().items()}
            self.dust3r.load_state_dict(ck.dust3r_from_reference(raw, self.dust3r_cfg, shapes),
                                        strict=True)
            del raw
        else:
            init_random_(self.dust3r, g)
        if self.opts.ckpt_path and os.path.exists(self.opts.ckpt_path):
            raw = ck.load_torch_file(self.opts.ckpt_path)
            shapes = {n: {k: v.shape for k, v in getattr(self.engine, n).state_dict().items()}
                      for n in SUBMODELS}
            self.engine.load_params(ck.lvdm_from_reference(raw, self.model_cfg, shapes))
            self.loaded_real_ckpt = True
            del raw
        else:
            self.engine.init_params(seed=self.opts.seed + 1)
        self._store_weights()

    def load_params(self, dust3r_state: dict, lvdm_state: dict) -> None:
        """Load port state dicts (e.g. from `convert.dust3r_from_jax_params`
        and `convert.from_jax_params`), strictly."""
        self.dust3r.load_state_dict(dust3r_state, strict=True)
        self.engine.load_params(lvdm_state)
        self._store_weights()

    def _store_weights(self) -> None:
        if self.opts.weights_dtype == "bf16":
            round_to_bf16_(self.dust3r)
            for name in SUBMODELS:
                round_to_bf16_(getattr(self.engine, name))

    # ------------------------------------------------------------------
    # dust3r + alignment
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _dust3r_pairs(self, imgs: np.ndarray, pairs, portrait: bool):
        """Encode each image once, decode each directed pair; returns the
        (pred_i, pred_j, conf_i, conf_j) host arrays in stored layout."""
        x = torch.as_tensor(imgs, device=self.device)
        tok, pos = zip(*(self.dust3r.encode(x[s:s + 8], is_portrait=portrait)
                         for s in range(0, len(x), 8)))
        tokens, pos = torch.cat(tok), torch.cat(pos)
        self._stage("dust3r_encode")
        h, w = imgs.shape[1:3]
        chunk = max(1, self.opts.batch_size)
        outs = {k: [] for k in ("pts3d1", "pts3d2_in_view1", "conf1", "conf2")}
        for s in range(0, len(pairs), chunk):
            batch = pairs[s:s + chunk]
            ii = torch.tensor([i for i, _ in batch], device=self.device)
            jj = torch.tensor([j for _, j in batch], device=self.device)
            out = self.dust3r.decode_pairs(tokens, pos, ii, jj, h=h, w=w,
                                           is_portrait1=portrait, is_portrait2=portrait)
            for k in outs:
                outs[k].append(out[k].cpu().numpy())
        self._stage("dust3r_decode")
        return [np.concatenate(outs[k]) for k in ("pts3d1", "pts3d2_in_view1", "conf1", "conf2")]

    def run_dust3r(self, images: List[vio.LoadedImage], clean_pc: bool = False) -> AlignedScene:
        """Complete symmetric pair graph -> DUSt3R -> global alignment
        (viewcrafter.py:47-59)."""
        pairs = make_pairs(len(images), scene_graph="complete", symmetrize=True)
        imgs = np.stack([im.img for im in images])  # (N, H, W, 3) in [-1, 1]
        # ManyAR portrait path: the network runs on landscape-stored images
        # with a batch-uniform orientation flag; the maps transpose back below
        portrait = imgs.shape[1] > imgs.shape[2]
        if portrait:
            imgs = imgs.transpose(0, 2, 1, 3)
        pred_i, pred_j, conf_i, conf_j = self._dust3r_pairs(imgs, pairs, portrait)
        if portrait:  # stored-landscape maps -> true portrait orientation
            imgs = imgs.transpose(0, 2, 1, 3)
            pred_i, pred_j = pred_i.transpose(0, 2, 1, 3), pred_j.transpose(0, 2, 1, 3)
            conf_i, conf_j = conf_i.transpose(0, 2, 1), conf_j.transpose(0, 2, 1)
        graph = SceneGraph(edges=np.asarray(pairs), pred_i=pred_i, pred_j=pred_j,
                           conf_i=conf_i, conf_j=conf_j, imgs=(imgs + 1.0) / 2.0)
        aligner = GlobalAligner(graph, self.align_cfg, device=self.device)
        params = aligner.init_mst()
        self._stage("align_init")
        params, _ = aligner.optimize(params)
        scene = aligner.get_scene(params, clip_thred=self.opts.dpt_trd)
        if clean_pc:
            scene = aligner.clean_pointcloud(scene)
        self._stage("align")
        self.scene = scene
        return scene

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------

    @torch.no_grad()
    def run_render(self, pts3d: np.ndarray, colors: np.ndarray, c2ws: np.ndarray, focals,
                   pps, hw: Tuple[int, int], nbv: bool = False):
        """Rasterize the trajectory (viewcrafter.py:61-90): (M, 3) world
        points with (M, 3) colors in [0, 1] along (V, 4, 4) cam-to-world
        poses -> ((V, H, W, 3) frames in [0, 1] at dust3r resolution, masks).
        With nbv the masks are a second render of the same points in colour
        1, (V, H, W, 1): each view's coverage; else None."""
        h, w = hw
        K = as_f32(make_intrinsics(
            np.broadcast_to(np.asarray(focals).reshape(-1), (len(c2ws),)),
            np.broadcast_to(np.asarray(pps).reshape(-1, 2), (len(c2ws), 2))), self.device)
        pts = as_f32(pts3d, self.device)
        w2cs = inv_se3(as_f32(c2ws, self.device))

        def render(cols):
            return render_trajectory(pts, cols, w2cs, K, h, w).cpu().numpy()

        frames = render(as_f32(colors, self.device))
        masks = render(torch.ones((len(pts), 1), device=self.device)) if nbv else None
        self._stage("render")
        return frames, masks

    def _selected_points(self, scene: AlignedScene, masks: Optional[np.ndarray], view_sel=None):
        pts, cols = scene.pts3d, scene.imgs
        sel_p, sel_c = [], []
        for i in (range(len(pts)) if view_sel is None else view_sel):
            if masks is None:
                sel_p.append(pts[i].reshape(-1, 3))
                sel_c.append(cols[i].reshape(-1, 3))
            else:
                m = masks[i].reshape(-1)
                sel_p.append(pts[i].reshape(-1, 3)[m])
                sel_c.append(cols[i].reshape(-1, 3)[m])
        return np.concatenate(sel_p), np.concatenate(sel_c)

    def _selected_points_last(self, pts, scene):
        return pts[-1].reshape(-1, 3), scene.imgs[-1].reshape(-1, 3)

    def _export_pc(self, path: str, sel_p: np.ndarray, sel_c: np.ndarray,
                   scene: Optional[AlignedScene] = None) -> str:
        """PLY export honouring --mask_pc / --reduce_pc (pvd_utils.py:476-504):
        mask_pc=False exports the full unmasked cloud, reduce_pc every 3rd
        point."""
        if not self.opts.mask_pc and scene is not None:
            sel_p, sel_c = self._selected_points(scene, None)
        if self.opts.reduce_pc:
            sel_p, sel_c = sel_p.reshape(-1, 3)[::3], sel_c.reshape(-1, 3)[::3]
        return vio.save_pointcloud_ply(sel_p, sel_c, path)

    def _conf_bg_masks(self, scene: AlignedScene) -> np.ndarray:
        """Confidence or background-depth masks of a multi-view cloud
        (viewcrafter.py:185-190). As the reference, the raw confidence is
        compared with log(min_conf_thr), and the background depth is taken
        over the 40-row inner crop."""
        conf_mask = scene.im_conf > float(np.log(self.opts.min_conf_thr))
        bg = []
        for d in scene.depths:
            inner = d[40:-40, :] if d.shape[0] > 80 else d
            bg.append(d > self.opts.bg_trd * (inner.max() + inner.min()))
        return conf_mask | np.stack(bg)

    def _choose_nbv(self, it: int, anchor, pts, colors, focal, pp, hw, num_candidates: int):
        """Next best view (viewcrafter.py:200-214): render the candidates'
        coverage, take the least covered, save its mask and lower the
        elevation by its theta. Returns the trajectory towards it."""
        opts = self.opts
        cand, thetas, phis = traj.generate_candidate_poses(anchor, opts.d_theta[0], opts.d_phi[0],
                                                           num_candidates=num_candidates)
        _, viewmasks = self.run_render(pts, np.ones_like(colors), cand, focal, pp, hw, nbv=True)
        nbv_id = int(np.argmin(viewmasks.sum(axis=(1, 2, 3))))
        vio.save_image(viewmasks[nbv_id],
                       os.path.join(opts.save_dir, f"candidate_mask{it}_nbv{nbv_id}.png"))
        self.elevation -= thetas[nbv_id]
        return traj.generate_traj_specified(anchor, thetas[nbv_id], phis[nbv_id], opts.d_r[0], 0,
                                            0, opts.video_length)

    # ------------------------------------------------------------------
    # diffusion
    # ------------------------------------------------------------------

    def _next_noise(self) -> Optional[GenerateNoise]:
        if self._noise is None:
            return None
        if not self._noise:
            raise ValueError("run(noise=...) holds fewer draws than the mode makes diffusion "
                             "calls")
        return self._noise.pop(0)

    def run_diffusion(self, frames01: Optional[np.ndarray], cond_idx: int = 0,
                      noise: Optional[GenerateNoise] = None) -> np.ndarray:
        """Guidance frames in [0, 1] (T, H, W, 3) -> generated video in
        [-1, 1] (viewcrafter.py:93-106 + image_guided_synthesis). The draws
        come from `noise` if given, else from the next of the draws handed
        to `run(noise=...)`, else from the pipeline's generator, seeded with
        opts.seed. With n_samples > 1 the extra samples are saved as
        diffusion_sample{i}.mp4 and sample 0 is returned, as in the
        reference; explicit draws then cover all samples of a sharded call
        (a batch of n_samples) and may not be given to the serial loop.

        With mesh_devices > 1 every rank calls this: rank 0's frames and
        cond_idx go to every rank (the others may pass None), and the
        samples run as one sharded batch (`_sample_mesh`), or, where no
        sharding regime fits, in the serial loop on every rank; only rank 0
        writes."""
        if self.world > 1:
            frames01, cond_idx = self._share_call(frames01, cond_idx)
        return self._diffuse(frames01, cond_idx, noise)

    def _share_call(self, frames01: Optional[np.ndarray], cond_idx: int):
        """Rank 0's (frames, cond_idx) on every rank, or None on every rank
        when rank 0 passes None frames (the end of its run)."""
        head = torch.zeros(5, dtype=torch.int64, device=self.device)
        if self.rank == 0 and frames01 is not None:
            head = torch.tensor([1, *frames01.shape[:3], cond_idx], device=self.device)
        head = pm.replicate(head).tolist()
        if not head[0]:
            return None
        buf = torch.empty((*head[1:4], 3), dtype=torch.float32, device=self.device)
        if self.rank == 0:
            buf = torch.as_tensor(np.asarray(frames01, np.float32), device=self.device)
        return pm.replicate(buf).cpu().numpy(), head[4]

    def _follow(self) -> None:
        """A rank other than 0: take part in each of rank 0's diffusion calls
        until its run ends."""
        while (call := self._share_call(None, 0)) is not None:
            self._diffuse(*call, None)

    def _diffuse(self, frames01: np.ndarray, cond_idx: int,
                 noise: Optional[GenerateNoise]) -> np.ndarray:
        opts = self.opts
        n = max(1, opts.n_samples)
        if noise is None:
            noise = self._next_noise()
        videos = torch.as_tensor(np.asarray(frames01, np.float32) * 2.0 - 1.0,
                                 device=self.device)[None]
        prompt = opts.prompt if opts.text_input else ""
        # a real checkpoint needs real CLIP BPE ids: without the merges file
        # this raises rather than hashing the words
        allow_fb = not self.loaded_real_ckpt
        ids = torch.from_numpy(tokenize([prompt], allow_fallback=allow_fb)).long()
        uids = torch.from_numpy(tokenize([""], allow_fallback=allow_fb)).long()
        if self.world > 1:  # rank 0's ids: the hash fallback is salted per process
            ids, uids = (pm.replicate(t.to(self.device)).cpu() for t in (ids, uids))
        guidance = GuidanceConfig(scale=opts.unconditional_guidance_scale,
                                  rescale=opts.guidance_rescale,
                                  cfg_img=opts.cfg_img if opts.multiple_cond_cfg else None,
                                  sequential=opts.sequential_cfg)
        kwargs = dict(steps=opts.ddim_steps, eta=opts.ddim_eta, guidance=guidance,
                      fs=opts.frame_stride, timestep_spacing=opts.timestep_spacing,
                      cond_idx=cond_idx, chunk=min(10, opts.ddim_steps),
                      attn_reuse_interval=opts.attn_reuse_interval,
                      attn_reuse_sites=tuple(opts.attn_reuse_sites),
                      attn_reuse_kinds=tuple(opts.attn_reuse_kinds),
                      attn_reuse_dtype=opts.attn_reuse_dtype,
                      generator=self.generator, on_stage=self.on_stage)
        mesh = self._sample_mesh(n, guidance.num_branches)
        if mesh is not None:
            # one sharded batch: the n chains ride dp, or their CFG branches do
            video = self.engine.generate_staged(
                videos.repeat(n, 1, 1, 1, 1), ids.repeat(n, 1), uids.repeat(n, 1),
                mesh=mesh, noise=noise, **kwargs)
            results = list(video.cpu().numpy())
        else:
            if noise is not None and n > 1:
                raise ValueError("explicit noise covers one call; the serial loop makes "
                                 f"n_samples = {opts.n_samples}")
            results = [self.engine.generate_staged(videos, ids, uids, noise=noise,
                                                   **kwargs)[0].cpu().numpy()
                       for _ in range(n)]
        if self.rank == 0:
            for si in range(1, n):
                vio.save_video((results[si] + 1.0) / 2.0,
                               os.path.join(opts.save_dir, f"diffusion_sample{si}.mp4"))
        return results[0]  # (T, H, W, 3) in [-1, 1]

    def _sample_mesh(self, n_samples: int, num_branches: int = 2):
        """The JAX package's `_sample_mesh`: a dp x tp mesh over the
        mesh_devices ranks (built once), dp = mesh_devices // mesh_tp, or
        None for the serial loop. Two dp regimes (`generate_staged`):
        n_samples % dp == 0 shards whole samples over dp; a single sample
        shards its K CFG guidance branches over dp instead (the reference
        runs the branches one after the other on one GPU,
        ddim.py:222-228); with dp == 1 the ranks shard the UNet alone."""
        opts = self.opts
        if opts.mesh_devices <= 1:
            return None
        tp = max(1, opts.mesh_tp)
        dp = opts.mesh_devices // tp
        if dp * tp != opts.mesh_devices:
            return None
        sample_dp = n_samples >= 2 and n_samples % dp == 0
        cfg_dp = (n_samples * num_branches) % dp == 0
        if not (sample_dp or cfg_dp or dp == 1):
            return None
        if self._mesh is None:
            self._mesh = pm.make_mesh(opts.mesh_devices, dp=dp, tp=tp,
                                      devices=[self.device] * self.world)
        return self._mesh

    def _diffuse_and_save(self, frames01: np.ndarray, name: str) -> np.ndarray:
        result = self.run_diffusion(frames01)
        vio.save_video((result + 1.0) / 2.0, os.path.join(self.opts.save_dir, name))
        self._stage("write_video")
        return result

    # ------------------------------------------------------------------
    # shared mode plumbing
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _upscale_to_target(self, frames01: np.ndarray) -> np.ndarray:
        h, w = self.model_cfg.height, self.model_cfg.width
        return resize_bilinear(as_f32(frames01, self.device), h, w).cpu().numpy()

    @torch.no_grad()
    def _scene_for_anchor(self, k: int, center_scale_ref: int):
        """Common preamble: re-anchor the world to the object center in front
        of camera k (viewcrafter.py:110-121)."""
        scene = self.scene
        h, w = scene.depths.shape[1:]
        depth_avg = scene.depths[center_scale_ref][h // 2, w // 2]
        radius = float(depth_avg * self.opts.center_scale)
        poses, pts = world_point_to_obj(as_f32(scene.poses, self.device),
                                        as_f32(scene.pts3d, self.device),
                                        k % len(scene.poses), radius, self.elevation)
        return poses.cpu().numpy(), pts.cpu().numpy(), radius, (h, w)

    # ------------------------------------------------------------------
    # modes
    # ------------------------------------------------------------------

    def nvs_single_view(self, save_suffix: str = "0") -> np.ndarray:
        """viewcrafter.py:108-169, also the first pass of the iterative
        modes. The scene was built from the duplicated single image; the
        last view is the anchor."""
        opts = self.opts
        scene = self.scene
        poses, pts, radius, (h, w) = self._scene_for_anchor(k=-1, center_scale_ref=-1)
        focal = scene.focals[-1]
        pp = scene.principal_points[-1]
        anchor = poses[-1]
        sel_p, sel_c = self._selected_points_last(pts, scene)

        if opts.mode in ("single_view_target", "single_view_ref_iterative",
                         "single_view_1drc_iterative"):
            depth_avg = radius / opts.center_scale
            c2ws = traj.generate_traj_specified(
                anchor, opts.d_theta[0], opts.d_phi[0], opts.d_r[0],
                opts.d_x[0] * depth_avg / focal, opts.d_y[0] * depth_avg / focal,
                opts.video_length)
        elif opts.mode == "single_view_txt":
            with open(opts.traj_txt) as f:
                lines = f.readlines()
            phi = [float(x) for x in lines[0].split()]
            theta = [float(x) for x in lines[1].split()]
            r = [float(x) for x in lines[2].split()]
            c2ws = traj.generate_traj_txt(anchor, phi, theta, r, opts.video_length)
            vio.save_trajectory_video(c2ws, os.path.join(opts.save_dir, "viz_traj.mp4"))
        elif opts.mode == "single_view_nbv":
            c2ws = self._choose_nbv(0, anchor, sel_p, sel_c, focal, pp, (h, w), num_candidates=2)
        else:
            raise KeyError(f"invalid mode: {opts.mode}")

        frames = self._upscale_to_target(self.run_render(sel_p, sel_c, c2ws, focal, pp, (h, w))[0])
        frames[0] = (self.img_ori + 1.0) / 2.0
        if opts.mode == "single_view_txt" and phi[-1] == 0.0 and theta[-1] == 0.0 and r[-1] == 0.0:
            frames[-1] = (self.img_ori + 1.0) / 2.0
        self.guidance_frames = frames

        vio.save_video(frames, os.path.join(opts.save_dir, f"render{save_suffix}.mp4"))
        self._export_pc(os.path.join(opts.save_dir, f"pcd{save_suffix}.ply"), sel_p, sel_c)
        # SceneViz analog (dust3r/viz.py:118-155): cloud + trajectory frustums
        from viewcrafter_tpu_torch.utils.viz import save_scene_ply

        save_scene_ply(os.path.join(opts.save_dir, f"scene{save_suffix}.ply"), sel_p, sel_c,
                       np.asarray(c2ws), focals=[float(focal)] * len(c2ws),
                       imsizes=[(w, h)] * len(c2ws))
        self._stage("write_render")
        return self._diffuse_and_save(frames, f"diffusion{save_suffix}.mp4")

    def nvs_sparse_view(self, it: int) -> np.ndarray:
        """Pass `it` >= 1 of the iterative modes (viewcrafter.py:171-234):
        the masked cloud of every view so far, re-anchored at the first view
        (ref) or the last (1drc, nbv)."""
        opts = self.opts
        scene = self.scene
        masks = self._conf_bg_masks(scene)
        if opts.mode == "single_view_ref_iterative":
            poses, pts, radius, (h, w) = self._scene_for_anchor(k=0, center_scale_ref=0)
            anchor, focal, pp = poses[0], scene.focals[0], scene.principal_points[0]
            cond_img = self.img_ori
        elif opts.mode in ("single_view_1drc_iterative", "single_view_nbv"):
            if opts.mode == "single_view_1drc_iterative":
                self.elevation -= opts.d_theta[it - 1]
            poses, pts, radius, (h, w) = self._scene_for_anchor(k=-1, center_scale_ref=0)
            anchor, focal, pp = poses[-1], scene.focals[-1], scene.principal_points[-1]
            cond_img = self.images[-1].img_ori
        else:
            raise KeyError(f"invalid iterative mode: {opts.mode}")
        anchored = scene_pts_override(scene, pts)
        sel_p, sel_c = self._selected_points(anchored, masks)
        if opts.mode == "single_view_nbv":
            c2ws = self._choose_nbv(it, anchor, sel_p, sel_c, focal, pp, (h, w), num_candidates=3)
        else:
            c2ws = traj.generate_traj_specified(anchor, opts.d_theta[it], opts.d_phi[it],
                                                opts.d_r[it], 0, 0, opts.video_length)

        frames = self._upscale_to_target(self.run_render(sel_p, sel_c, c2ws, focal, pp, (h, w))[0])
        frames[0] = (cond_img + 1.0) / 2.0
        self.guidance_frames = frames
        vio.save_video(frames, os.path.join(opts.save_dir, f"render{it}.mp4"))
        self._export_pc(os.path.join(opts.save_dir, f"pcd{it}.ply"), sel_p, sel_c, scene=anchored)
        self._stage("write_render")
        return self._diffuse_and_save(frames, f"diffusion{it}.mp4")

    def nvs_sparse_view_interp(self) -> np.ndarray:
        """A B-spline path through N >= 2 views (viewcrafter.py:236-279): the
        views sit at every (video_length - 1)-th frame, and each segment
        between two of them is one diffusion call; the segments' videos are
        concatenated."""
        opts = self.opts
        scene = self.scene
        h, w = scene.depths.shape[1:]
        n = len(self.images)
        masks = None if n == 2 else self._conf_bg_masks(scene)
        c2ws = traj.interp_traj(scene.poses, n_inserts=opts.video_length)
        focals = traj.interpolate_sequence(scene.focals, opts.video_length - 2)
        pps = traj.interpolate_sequence(scene.principal_points, opts.video_length - 2)
        sel_p, sel_c = self._selected_points(scene, masks)
        frames = self._upscale_to_target(self.run_render(sel_p, sel_c, c2ws, focals, pps, (h, w))[0])
        seg = opts.video_length - 1
        for i in range(n):
            frames[i * seg] = (self.img_gts[i] + 1.0) / 2.0
        self.guidance_frames = frames
        vio.save_video(frames, os.path.join(opts.save_dir, "render.mp4"))
        self._export_pc(os.path.join(opts.save_dir, "pcd.ply"), sel_p, sel_c, scene=scene)
        self._stage("write_render")
        result = np.concatenate([self.run_diffusion(frames[i * seg:i * seg + opts.video_length])
                                 for i in range(n - 1)])
        vio.save_video((result + 1.0) / 2.0, os.path.join(opts.save_dir, "diffusion.mp4"))
        self._stage("write_video")
        return result

    def nvs_single_view_eval(self) -> np.ndarray:
        """The eval protocol (viewcrafter.py:281-309): the clip's own
        trajectory, recovered from all its frames and re-anchored at frame 0;
        then frame 0 alone, duplicated, gives the cloud (and replaces
        `self.scene`), rendered along that trajectory."""
        opts = self.opts
        scene = self.scene
        h, w = scene.depths.shape[1:]
        poses, _ = world_point_to_kth(as_f32(scene.poses, self.device),
                                      as_f32(scene.pts3d, self.device), 0)
        c2ws = poses.cpu().numpy()
        focals, pps = scene.focals, scene.principal_points
        ref_scene = self.run_dust3r([self.images[0], self.images[0]])
        sel_p = ref_scene.pts3d[0].reshape(-1, 3)
        sel_c = ref_scene.imgs[0].reshape(-1, 3)
        frames = self._upscale_to_target(
            self.run_render(sel_p, sel_c, c2ws, focals[:1], pps[:1], (h, w))[0])
        frames[0] = (self.img_gts[0] + 1.0) / 2.0
        self.guidance_frames = frames
        vio.save_video(frames, os.path.join(opts.save_dir, "render_ref0.mp4"))
        self._stage("write_render")
        return self._diffuse_and_save(frames, "diffusion_ref0.mp4")

    def _iterative(self, n_iters: int) -> List[np.ndarray]:
        """The iterative modes (viewcrafter.py:311-382): pass 0 is the
        single-view mode; before each later pass every 6th generated frame,
        taken down to DUSt3R's size, joins the views, and DUSt3R and the
        alignment run again on all of them with the cloud cleaned."""
        results = []
        for it in range(n_iters):
            if it == 0:
                result = self.nvs_single_view()
            else:
                for i in range(ITERATIVE_SAMPLE_RATE, len(result), ITERATIVE_SAMPLE_RATE):
                    frame = vio.resize_to_dust3r(result[i], hw=self.images[0].img.shape[:2],
                                                 device=self.device)
                    self.images.append(vio.LoadedImage(img=frame, img_ori=result[i],
                                                       index=len(self.images)))
                self.run_dust3r(self.images, clean_pc=True)
                result = self.nvs_sparse_view(it)
            results.append(result)
        return results

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------

    def load_inputs(self, images: Optional[List[vio.LoadedImage]] = None) -> None:
        """The input views at DUSt3R's resolution and their crops at the
        diffusion resolution (`img_ori`, `img_gts`): loaded from
        opts.image_dir, or taken from `images` if given. The multi-view
        modes need two views or more; the others use the first view,
        duplicated into a pair."""
        if images is None:
            images = vio.load_images(self.opts.image_dir, size=self.opts.dust3r_size,
                                     target_hw=(self.model_cfg.height, self.model_cfg.width))
        images = list(images)
        self.img_ori = images[0].img_ori
        if self.opts.mode in MULTI_VIEW_MODES:
            if len(images) < 2:
                raise ValueError("sparse/eval modes need >= 2 input views")
            self.img_gts = [im.img_ori for im in images]
        else:
            self.img_gts = [self.img_ori]
            if len(images) == 1:
                images = [images[0], dataclasses.replace(images[0], index=1)]
        self.images = images

    def run(self, noise=None, images: Optional[List[vio.LoadedImage]] = None):
        """The whole path of opts.mode. `images`: the input views, loaded
        from opts.image_dir if not given. `noise`: the diffusion draws, one
        `GenerateNoise` or a list of them, one per diffusion call (an
        iteration or a segment) in order; it raises if the list runs short,
        and without it the pipeline's generator draws. Returns the video
        (T, H, W, 3) in [-1, 1], or the list of each iteration's video in
        the iterative modes; on a rank other than 0 of a multi-device run,
        None (that rank only takes part in the diffusion calls)."""
        opts = self.opts
        modes = {
            "single_view_target": self.nvs_single_view,
            "single_view_txt": self.nvs_single_view,
            "sparse_view_interp": self.nvs_sparse_view_interp,
            "single_view_eval": self.nvs_single_view_eval,
            "single_view_ref_iterative": lambda: self._iterative(len(opts.d_phi)),
            "single_view_1drc_iterative": lambda: self._iterative(len(opts.d_phi)),
            "single_view_nbv": lambda: self._iterative(self.nbv_passes),
        }
        if opts.mode not in modes:
            raise KeyError(f"invalid mode: {opts.mode}")
        self._noise = None if noise is None else (
            [noise] if isinstance(noise, GenerateNoise) else list(noise))
        try:
            if self.rank != 0:
                return self._follow()
            os.makedirs(opts.save_dir, exist_ok=True)
            self.elevation = opts.elevation
            self.load_inputs(images)
            self.run_dust3r(self.images, clean_pc=opts.mode == "sparse_view_interp")
            return modes[opts.mode]()
        finally:
            self._noise = None
            if self.world > 1 and self.rank == 0:
                self._share_call(None, 0)  # the end of the run: the other ranks return


def scene_pts_override(scene: AlignedScene, pts: np.ndarray) -> AlignedScene:
    """The scene with re-anchored points (after world_point_to_obj)."""
    return dataclasses.replace(scene, pts3d=np.asarray(pts))
