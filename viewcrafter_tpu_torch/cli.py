"""Command-line entry point of the PyTorch package, flag-compatible with the
reference (inference.py:8-31 + configs/infer_config.py:4-59); the port's own
copy of the JAX package's `cli.py`, with `--device` (default: the card).

  python -m viewcrafter_tpu_torch.cli --image_dir test/images/fruit.png \
      --mode single_view_target --d_phi 30 --ddim_steps 50

  python -m viewcrafter_tpu_torch.cli --image_dir test/images/fruit.png \
      --mode single_view_txt --traj_txt test/trajs/loop2.txt

  python -m viewcrafter_tpu_torch.cli --image_dir test/images_sparse/bicycle \
      --mode sparse_view_interp

  python -m viewcrafter_tpu_torch.cli --image_dir test/images/fruit.png \
      --mode single_view_1drc_iterative --d_theta -5 -5 --d_phi 30 30 \
      --d_r -0.2 -0.2 --d_x 0 0 --d_y 0 0

Every mode of the reference runs. Without checkpoints the models hold
seeded random weights (the output is untrained noise); loading the released
checkpoints and multi-device sampling are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="viewcrafter_tpu_torch inference")
    # general
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card (cuda), and an error without one")
    p.add_argument("--image_dir", type=str, default="./test/images/fruit.png")
    p.add_argument("--out_dir", type=str, default="./output")
    p.add_argument("--exp_name", type=str, default=None)
    # renderer
    p.add_argument("--mode", type=str, default="single_view_txt",
                   choices=["single_view_target", "single_view_txt", "single_view_eval",
                            "sparse_view_interp", "single_view_ref_iterative",
                            "single_view_1drc_iterative", "single_view_nbv"])
    p.add_argument("--traj_txt", type=str, default=None)
    p.add_argument("--elevation", type=float, default=5.0)
    p.add_argument("--center_scale", type=float, default=1.0)
    p.add_argument("--d_theta", nargs="+", type=float, default=[10.0])
    p.add_argument("--d_phi", nargs="+", type=float, default=[30.0])
    p.add_argument("--d_r", nargs="+", type=float, default=[-0.2])
    p.add_argument("--d_x", nargs="+", type=float, default=[0.0])
    p.add_argument("--d_y", nargs="+", type=float, default=[0.0])
    # mask_image is parsed for flag parity but dead in the reference too
    # (infer_config.py:23 defines it; no call site reads opts.mask_image)
    p.add_argument("--mask_image", type=bool, default=False)
    p.add_argument("--mask_pc", type=bool, default=True,
                   help="False: export PLYs unmasked (pvd_utils.py get_pc)")
    p.add_argument("--reduce_pc", type=bool, default=False,
                   help="subsample exported PLYs ::3 (pvd_utils.py get_pc)")
    p.add_argument("--bg_trd", type=float, default=0.0)
    p.add_argument("--dpt_trd", type=float, default=1.0)
    # diffusion
    p.add_argument("--model", type=str, default="viewcrafter_25",
                   help="model preset: viewcrafter_25 | viewcrafter_16 | viewcrafter_25_512")
    p.add_argument("--ckpt_path", type=str, default="./checkpoints/model.ckpt")
    p.add_argument("--config", type=str, default=None,
                   help="accepted for reference-CLI compatibility; presets replace yaml")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--frame_stride", type=int, default=10)
    p.add_argument("--unconditional_guidance_scale", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--video_length", type=int, default=25)
    p.add_argument("--prompt", type=str, default="Rotating view of a scene")
    p.add_argument("--negative_prompt", default=False)
    p.add_argument("--text_input", default=True)
    p.add_argument("--multiple_cond_cfg", action="store_true", default=False)
    p.add_argument("--cfg_img", type=float, default=None)
    p.add_argument("--timestep_spacing", type=str, default="uniform_trailing")
    p.add_argument("--guidance_rescale", type=float, default=0.7)
    p.add_argument("--perframe_ae", default=True)
    p.add_argument("--n_samples", type=int, default=1)
    # memory / speed knobs (no reference equivalent)
    p.add_argument("--sequential_cfg", action="store_true", default=False,
                   help="evaluate CFG branches sequentially (lower peak memory)")
    p.add_argument("--attn_reuse_interval", type=int, default=1,
                   help=">1 enables Pyramid-Attention-Broadcast reuse: attention is "
                        "recomputed every N steps and broadcast in between "
                        "(arXiv:2408.12588); 1 = exact sampling")
    p.add_argument("--attn_reuse_sites", type=str, default="",
                   help="comma-separated site-name prefixes to cache for PAB reuse "
                        "(e.g. 'down_0,up_0,init_attn'); empty = all sites")
    p.add_argument("--attn_reuse_kinds", type=str, default="spatial,cross,temporal",
                   help="attention families to cache for PAB reuse; add 'ff' to "
                        "also broadcast feed-forward deltas (coarser, faster)")
    p.add_argument("--attn_reuse_dtype", type=str, default="bf16", choices=["bf16", "f8"],
                   help="PAB cache storage dtype; f8 halves the cache's memory")
    p.add_argument("--weights_dtype", type=str, default="bf16", choices=["bf16", "fp32"],
                   help="inference weight storage dtype")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help=">1: multi-device sampling (not ported; raises)")
    p.add_argument("--mesh_tp", type=int, default=1,
                   help="tensor-parallel width (not ported)")
    # dust3r
    p.add_argument("--model_path", type=str,
                   default="./checkpoints/DUSt3R_ViTLarge_BaseDecoder_512_dpt.pth")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--schedule", type=str, default="linear")
    p.add_argument("--niter", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--min_conf_thr", type=float, default=3.0)
    p.add_argument("--dust3r_size", type=int, default=512,
                   help="dust3r input long-side resolution")
    p.add_argument("--dust3r_model", type=str, default="dust3r_512",
                   help="dust3r architecture preset: dust3r_512 | dust3r_tiny")
    return p


def opts_from_args(args) -> "InferenceOptions":
    from viewcrafter_tpu_torch.pipeline import InferenceOptions

    # pick the model preset from resolution/length flags when not explicit
    model = args.model
    if model == "viewcrafter_25":
        if args.height == 320 or args.width == 512:
            model = "viewcrafter_25_512"
        elif args.video_length == 16:
            model = "viewcrafter_16"
    return InferenceOptions(
        image_dir=args.image_dir,
        out_dir=args.out_dir,
        exp_name=args.exp_name,
        mode=args.mode,
        traj_txt=args.traj_txt,
        elevation=args.elevation,
        center_scale=args.center_scale,
        d_theta=args.d_theta,
        d_phi=args.d_phi,
        d_r=args.d_r,
        d_x=args.d_x,
        d_y=args.d_y,
        mask_image=args.mask_image,
        mask_pc=args.mask_pc,
        reduce_pc=args.reduce_pc,
        bg_trd=args.bg_trd,
        dpt_trd=args.dpt_trd,
        model=model,
        ckpt_path=args.ckpt_path,
        ddim_steps=args.ddim_steps,
        ddim_eta=args.ddim_eta,
        height=args.height,
        width=args.width,
        frame_stride=args.frame_stride,
        unconditional_guidance_scale=args.unconditional_guidance_scale,
        seed=args.seed,
        video_length=args.video_length,
        prompt=args.prompt,
        text_input=bool(args.text_input),
        multiple_cond_cfg=args.multiple_cond_cfg,
        cfg_img=args.cfg_img,
        timestep_spacing=args.timestep_spacing,
        guidance_rescale=args.guidance_rescale,
        n_samples=args.n_samples,
        sequential_cfg=args.sequential_cfg,
        attn_reuse_interval=args.attn_reuse_interval,
        attn_reuse_sites=tuple(s for s in args.attn_reuse_sites.split(",") if s),
        attn_reuse_kinds=tuple(s for s in args.attn_reuse_kinds.split(",") if s),
        attn_reuse_dtype=args.attn_reuse_dtype,
        weights_dtype=args.weights_dtype,
        mesh_devices=args.mesh_devices,
        mesh_tp=args.mesh_tp,
        model_path=args.model_path,
        batch_size=args.batch_size,
        niter=args.niter,
        lr=args.lr,
        schedule=args.schedule,
        min_conf_thr=args.min_conf_thr,
        dust3r_size=args.dust3r_size,
        dust3r_model=args.dust3r_model,
    )


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.exp_name is None:
        prefix = datetime.now().strftime("%Y%m%d_%H%M")
        args.exp_name = f"{prefix}_{os.path.splitext(os.path.basename(args.image_dir.rstrip('/')))[0]}"
    opts = opts_from_args(args)

    from viewcrafter_tpu_torch.pipeline import ViewCrafterPipeline

    pipeline = ViewCrafterPipeline(opts, device=args.device)
    pipeline.run()
    print(f"done; artifacts in {opts.save_dir}")


if __name__ == "__main__":
    main()
