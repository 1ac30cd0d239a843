"""Novel-view synthesis requests: the diffusion stage of ViewCrafter as its
pipeline calls it (`ViewCrafterPipeline._diffuse` -> `VideoDiffusionEngine.
generate_staged`), one request at a time.

A request is what the pipeline hands the engine after it has rendered the
point cloud: a guidance clip of `video_length` frames whose frame 0 is the
photo, the later frames the photo panned and tilted a little further each
frame with the uncovered border and a few rectangles left empty (the holes
a render leaves), a prompt of 77 token ids, and every random draw of the
sampler. All of it comes from the seed and the request's index; every
request has the same sizes.

The mix (a JSON file beside this one) gives the sampler's settings and the
clip's parameters: `steps`, `eta`, `guidance_scale`, `guidance_rescale`,
`frame_stride`, `timestep_spacing`, `chunk`, the attention-reuse options
(`attn_reuse_interval`, `attn_reuse_kinds`, `attn_reuse_sites`,
`attn_reuse_dtype`), `photos` (a directory of PNGs), `pan` and `tilt`
(ranges of the last frame's shift as a share of the width and height),
`holes` (rectangles per frame), `hole_size` (range of their side as a share
of the frame) and `prompt_words`.

`correct`: the program is followed step by step from its own state (its
latents), since a chain of 50 steps from random weights amplifies rounding
beyond any comparison; the start and each stage are checked on their own
against the float32 reference (`h100bench/reference`), which works out the
conditioning, the schedule and the networks again from the raw inputs.
The request checked is the window's last, which is always served whole:
every request's state (each step's latents and v, the contexts, the decoded
frames the check reads) is copied, as it is made, into pinned host buffers
that each request refills, so the card holds nothing of a request once it is
served and the peak does not depend on how many the window holds; its
inputs are drawn again from (seed, index). The numbers:
  cond_err   the guidance latents (VAE encode with the request's posterior
             draws) and the CFG contexts (CLIP text, CLIP vision, resampler)
  unet_err   the UNet's v at a step drawn from the seed and at the last step;
             under attention reuse, at a full step drawn from the seed and
             at both reuse steps of its cell, with the reference's own cache
  step_err   the DDIM update (CFG, rescale, the step) at every step
  video_err  the last update and the VAE decode of frames drawn from the seed
Each is the largest relative RMS error over branches, frames and steps.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from h100bench import flops, weights
from h100bench.photos import read_png
from h100bench.reference import sampler as ref_sampler
from h100bench.reference.models import Cache, Ctx, DiffusionModels, clip_preprocess
from h100bench.reference.numerics import Numerics, set_strict_f32

SOT, EOT = 49406, 49407


def port_config(cfg: dict):
    """The program's ModelConfig for a configuration file."""
    from viewcrafter_tpu_torch import config as pc

    def make(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    return pc.ModelConfig(
        name=cfg["name"], diffusion=make(pc.DiffusionConfig, cfg["diffusion"]),
        unet=make(pc.UNetConfig, cfg["unet"]), vae=make(pc.VAEConfig, cfg["vae"]),
        resampler=make(pc.ResamplerConfig, cfg["resampler"]),
        clip_text=make(pc.CLIPTextConfig, cfg["clip_text"]),
        clip_vision=make(pc.CLIPVisionConfig, cfg["clip_vision"]),
        video_length=cfg["video_length"], height=cfg["height"], width=cfg["width"])


def rel(a, b, keep: int):
    """Relative RMS error of a against b over every axis after the first
    `keep`, largest over those."""
    a, b = a.double(), b.double()
    axes = tuple(range(keep, a.ndim))
    num = (a - b).square().sum(dim=axes)
    den = b.square().sum(dim=axes).clamp(min=1e-300)
    return float((num / den).sqrt().max())


def shifted(n: int, d: int, dest: bool) -> slice:
    """The rows (or columns) of a length-n axis that a shift by d moves from
    (`dest` False) or to (`dest` True)."""
    lo, hi = (d, n) if d >= 0 else (0, n + d)
    return slice(lo, hi) if dest else slice(lo - d, hi - d)


@dataclasses.dataclass
class Request:
    index: int
    frames: torch.Tensor  # (1, T, H, W, 3) in [-1, 1]
    ids: torch.Tensor
    uids: torch.Tensor
    noise: object  # the program's GenerateNoise
    kinds: list = dataclasses.field(default_factory=list)  # each UNet call's kind


class Pinned:
    """Host copies of one request's tensors, refilled by every request. On a
    card the buffers are pinned and the copies queued on the card's stream,
    so the window never waits for them; the buffers are made in the warm-up
    (`reserve`), so the window allocates none."""

    def __init__(self, pin: bool):
        self.pin, self.bufs, self.frozen = pin, {}, False

    def put(self, key, t: torch.Tensor):
        buf = self.bufs.get(key)
        if buf is None:
            if self.frozen:
                raise KeyError(f"no host buffer reserved for {key!r}")
            buf = self.bufs[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pin)
        buf.copy_(t.detach(), non_blocking=self.pin)

    def reserve(self, like, keys):
        for key in keys:
            if key not in self.bufs:
                buf = self.bufs[like]
                self.bufs[key] = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=self.pin)
        self.frozen = True

    def get(self, key, device) -> torch.Tensor:
        return self.bufs[key].to(device)


class Cell:
    """One cell of this kind: the program built from the configuration, its
    requests, and the check of what they produced."""

    def __init__(self, root: Path, cfg: dict, mix: dict, check: dict, seed: int, device):
        self.root, self.cfg, self.mix, self.limits = root, cfg, mix, check
        self.seed, self.device = seed, torch.device(device)
        self.k = 1 if mix["guidance_scale"] == 1.0 else 2
        self.pab = mix.get("attn_reuse_interval", 1) > 1
        self.served = []  # (index, the kinds of its UNet calls) of each request served
        t = cfg["video_length"]
        self.picks = sorted(int(f) for f in np.random.default_rng([seed, 4]).choice(
            t, size=min(check["decode_frames"], t), replace=False))
        self.kept = Pinned(self.device.type == "cuda")

    # ------------------------------------------------------------------
    # the system under test
    # ------------------------------------------------------------------

    def setup(self):
        from viewcrafter_tpu_torch.models.lvdm import VideoDiffusionEngine

        self.engine = VideoDiffusionEngine(port_config(self.cfg), device=self.device)
        state = weights.make(self.cfg, weights.weight_seed(self.seed), self.device)
        self.engine.load_params(state)
        del state
        photos = sorted((self.root / self.mix["photos"]).glob("*.png"))
        pick = np.random.default_rng([self.seed, 1]).integers(len(photos))
        self.photo_name = photos[pick].name
        px = torch.from_numpy(read_png(photos[pick])).to(self.device)
        photo = px.permute(2, 0, 1)[None].float() / 255.0
        h, w = self.cfg["height"], self.cfg["width"]
        if photo.shape[-2:] != (h, w):
            photo = F.interpolate(photo, size=(h, w), mode="bilinear", antialias=True,
                                  align_corners=False)
        self.photo = photo[0].permute(1, 2, 0).clamp(0, 1).contiguous()
        self._hook = self.engine.unet.register_forward_hook(self._keep, with_kwargs=True)
        self._current = None

    def request(self, i: int) -> Request:
        """Request i's inputs, drawn from (seed, i)."""
        from viewcrafter_tpu_torch.models.lvdm import GenerateNoise

        m, cfg = self.mix, self.cfg
        rng = np.random.default_rng([self.seed, 2, i])
        t, h, w = cfg["video_length"], cfg["height"], cfg["width"]
        sign = rng.choice([-1.0, 1.0], size=2)
        pan = sign[0] * rng.uniform(*m["pan"]) * w
        tilt = sign[1] * rng.uniform(*m["tilt"]) * h
        frames = torch.zeros((t, h, w, 3), device=self.device)
        for f in range(t):
            dx, dy = (int(round(f / max(t - 1, 1) * v)) for v in (pan, tilt))
            frames[f, shifted(h, dy, True), shifted(w, dx, True)] = \
                self.photo[shifted(h, dy, False), shifted(w, dx, False)]
            if f:
                for _ in range(m["holes"]):
                    hh = int(rng.uniform(*m["hole_size"]) * h)
                    hw = int(rng.uniform(*m["hole_size"]) * w)
                    y0, x0 = int(rng.integers(0, h - hh + 1)), int(rng.integers(0, w - hw + 1))
                    frames[f, y0:y0 + hh, x0:x0 + hw] = 0.0
        ids = torch.zeros((1, 77), dtype=torch.long)
        words = rng.integers(1000, 49000, m["prompt_words"])
        ids[0, :len(words) + 2] = torch.tensor([SOT, *words.tolist(), EOT])
        uids = torch.zeros((1, 77), dtype=torch.long)
        uids[0, :2] = torch.tensor([SOT, EOT])
        gen = torch.Generator(device=self.device).manual_seed(int(rng.integers(1 << 62)))
        f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
        shape = (1, t, h // f, w // f, cfg["vae"]["z_channels"])

        def randn(*s):
            return torch.randn(s, generator=gen, device=self.device)

        noise = GenerateNoise(x_T=randn(*shape), steps=randn(m["steps"], *shape),
                              posterior=randn(*shape))
        return Request(i, frames[None] * 2.0 - 1.0, ids.to(self.device), uids.to(self.device),
                       noise)

    def serve(self, req: Request, on_stage=None, steps: int = 0):
        """The request through `generate_staged` as the pipeline calls it
        (`steps`, when given, shortens the chain: the warm-up's); the frames
        the check decodes go to the host, the video is dropped."""
        from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

        m = self.mix
        steps = steps or m["steps"]
        self._current = req
        video = self.engine.generate_staged(
            req.frames, req.ids, req.uids, steps=steps, eta=m["eta"],
            guidance=GuidanceConfig(scale=m["guidance_scale"], rescale=m["guidance_rescale"]),
            fs=m["frame_stride"], timestep_spacing=m["timestep_spacing"], cond_idx=0,
            chunk=min(m["chunk"], steps), attn_reuse_interval=m.get("attn_reuse_interval", 1),
            attn_reuse_kinds=tuple(m.get("attn_reuse_kinds", ("spatial", "cross", "temporal"))),
            attn_reuse_sites=tuple(m.get("attn_reuse_sites", ())),
            attn_reuse_dtype=m.get("attn_reuse_dtype", "bf16"), noise=req.noise,
            on_stage=on_stage)
        self._current = None
        self.kept.put("video", video[:, self.picks])
        self.served.append((req.index, req.kinds))

    def warm_up(self):
        """Every shape the requests use: the conditioning, the UNet call of
        each kind the sampler makes, the decode; and the host buffers of
        every step's state."""
        req = self.request(1 << 30)
        steps = self.mix.get("attn_reuse_interval", 1) + 1
        req.noise.steps = req.noise.steps[:steps]
        self.serve(req, steps=steps)
        self.served.clear()
        n = self.mix["steps"]
        self.kept.reserve(("x", 0), [("x", i) for i in range(n)])
        self.kept.reserve(("v", 0), [("v", i) for i in range(n)])

    def _keep(self, module, args, kwargs, out):
        """Forward hook on the UNet: copy each call's state to the host (this
        row block's input, the latents beside the guidance latents, whole, so
        that the copy needs no kernel; the branches' v; the contexts of the
        first call)."""
        req = self._current
        if req is None:
            return
        i = len(req.kinds)
        req.kinds.append("full" if kwargs.get("collect_cache") else
                         "reuse" if kwargs.get("attn_cache") is not None else "step")
        y = out[0] if isinstance(out, tuple) else out
        x = args[0]
        if i == 0:
            self.kept.put("context", args[2])
        self.kept.put(("x", i), x[:x.shape[0] // self.k])
        self.kept.put(("v", i), y)

    def release(self):
        """Free the program's state before the reference runs."""
        self._hook.remove()
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def model_flops(self) -> float:
        """Model FLOPs of every request served."""
        return sum(flops.video(self.cfg, self.mix["steps"], self.k,
                               sum(1 for k in kinds if k == "reuse"),
                               tuple(self.mix.get("attn_reuse_kinds", ())))
                   for _, kinds in self.served)

    # ------------------------------------------------------------------
    # the check
    # ------------------------------------------------------------------

    @torch.no_grad()
    def check(self, control: bool = False) -> dict:
        """{"program": {number: value}} of the last request served; with
        `control`, also {"control": {number: value}}: the reference in the
        precision below the configuration's in the program's place."""
        if self.device.type == "cuda":
            set_strict_f32()
        index, kinds = self.served[-1]
        req = self.request(index)
        plan = self._plan(kinds)
        with torch.device(self.device):
            nets = DiffusionModels(self.cfg)
        state = weights.make(self.cfg, weights.weight_seed(self.seed), self.device)
        for group, params in state.items():
            getattr(nets, group).load_state_dict({k: v.float() for k, v in params.items()})
        del state
        ref = self._stages(nets, req, plan, Ctx(Numerics("f32")), None)
        out = {"program": self._compare(self._program(plan), ref)}
        if control:
            lower = self._stages(nets, req, plan, Ctx(Numerics("fp8")), Numerics("bf16"))
            out["control"] = self._compare(lower, ref)
        return out

    def _plan(self, kinds: list) -> dict:
        """The UNet calls the check reads, drawn from the seed: a step and
        the last; under attention reuse, a full step whose next two steps
        reuse its cache, and those two."""
        rng = np.random.default_rng([self.seed, 5])
        n = len(kinds)
        if self.pab:
            fulls = [f for f in range(n - 2)
                     if kinds[f] == "full" and kinds[f + 1] == kinds[f + 2] == "reuse"]
            f = fulls[int(rng.integers(len(fulls)))]
            return {"full": f, "unet": [f, f + 1, f + 2], "steps": n}
        return {"full": None, "unet": [int(rng.integers(n - 1)), n - 1], "steps": n}

    def _stages(self, nets, req: Request, plan: dict, ctx: Ctx, update_num) -> dict:
        """Every value the check compares, as `ctx`'s arithmetic gives it,
        from the raw inputs and the program's latents."""
        cfg, m, dev = self.cfg, self.mix, self.device
        scale = cfg["diffusion"]["scale_factor"]
        frames, noise = req.frames, req.noise
        z = torch.cat([nets.vae.encode(ctx, frames[:, t], noise.posterior[:, t])[:, None]
                       for t in range(frames.shape[1])], dim=1) * scale

        def image_ctx(img):
            return nets.resampler(ctx, nets.clip_vision(ctx, clip_preprocess(img)))

        cond_img = frames[:, 0]
        cond = torch.cat([nets.clip_text(ctx, req.ids), image_ctx(cond_img)], dim=1)
        uncond = torch.cat([nets.clip_text(ctx, req.uids), image_ctx(torch.zeros_like(cond_img))],
                           dim=1)
        contexts = torch.cat([uncond, cond]) if self.k == 2 else cond
        sched = ref_sampler.Schedule(cfg["diffusion"], m["steps"], m["eta"])
        fs = torch.full((self.k,), float(m["frame_stride"]), device=dev)
        kinds = tuple(m.get("attn_reuse_kinds", ()))
        cache = Cache()
        if plan["full"] is not None:
            cache = Cache(kinds, collect=True, sites=tuple(m.get("attn_reuse_sites", ())))
        v = {}
        for i in plan["unet"]:
            x = torch.cat([self._latent(i), z], dim=-1).repeat(self.k, 1, 1, 1, 1)
            v[i] = nets.unet(ctx, x, ref_sampler.timesteps(sched, i, self.k, dev), contexts, fs,
                             cache)
            if i == plan["full"]:
                cache = Cache(kinds, reads=cache.writes)
        del cache
        rnd = (lambda t: t) if update_num is None else update_num.round

        def update(i):
            return ref_sampler.update(sched, i, self._latent(i),
                                      ref_sampler.guide(self.kept.get(("v", i), dev),
                                                        m["guidance_scale"],
                                                        m["guidance_rescale"]),
                                      noise.steps[i], rnd)

        # each update from the program's latents and v: the sampler's stage on its own
        last = plan["steps"] - 1
        steps = {i + 1: update(i) for i in range(last)}
        final = update(last)
        video = {t: nets.vae.decode(ctx, final[:, t] / scale).clamp(-1.0, 1.0)
                 for t in self.picks}
        return {"z": z, "contexts": contexts, "v": v, "steps": steps, "video": video}

    def _latent(self, i: int) -> torch.Tensor:
        """The program's latents at UNet call i."""
        return self.kept.get(("x", i), self.device)[..., :self.cfg["vae"]["z_channels"]]

    def _program(self, plan: dict) -> dict:
        """What the program produced, in the shape `_stages` gives."""
        dev, kept = self.device, self.kept
        video = kept.get("video", dev)
        zc = self.cfg["vae"]["z_channels"]
        return {"z": kept.get(("x", 0), dev)[..., -zc:], "contexts": kept.get("context", dev),
                "v": {i: kept.get(("v", i), dev) for i in plan["unet"]},
                "steps": {i: self._latent(i) for i in range(1, plan["steps"])},
                "video": {t: video[:, j] for j, t in enumerate(self.picks)}}

    @staticmethod
    def _compare(got: dict, ref: dict) -> dict:
        """The four numbers of `got` (the program's, or the control's)."""
        cond = max(rel(got["z"][0], ref["z"][0], 1), rel(got["contexts"], ref["contexts"], 1))
        unet = max(rel(got["v"][i], ref["v"][i], 2) for i in ref["v"])
        step = max(rel(got["steps"][i][0], ref["steps"][i][0], 1) for i in ref["steps"])
        video = max(rel(got["video"][t], ref["video"][t], 1) for t in ref["video"])
        return {"cond_err": cond, "unet_err": unet, "step_err": step, "video_err": video}
