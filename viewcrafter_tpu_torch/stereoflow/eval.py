"""Stereo/flow benchmark evaluation CLI: the port of the JAX package's
`stereoflow/eval.py`, with the same flags and `--device`.

Parity target: extern/dust3r/croco/stereoflow/test.py: load a downstream
CroCo checkpoint, run tiled overlapping-crop inference over one or more test
data sets, and save metrics, raw predictions, visualizations, error maps or
leaderboard submission files (test.py:82-126 `_save_batch`, :128-209 `main`).

As in the JAX package:
  - the weights are the port's own file (`utils.checkpoint.save_params` of
    a state dict or of a `training.TrainState`) with a JSON sidecar
    `<model>.json` holding what the reference pickles in the checkpoint's
    `args` (task, with_conf, crop, tile_conf_mode, the croco topology's
    overrides);
  - metrics are written as JSON, predictions as .npy;
  - every tile of a pair rides one forward (`engine.tiled_pred`).
The model runs on the card unless `--device` names another device; without
a card and without `--device cpu` it raises. The card's machine has no PIL:
`--save visu` and `err10` and the PNG submission formats need it there.

Usage:
  python -m viewcrafter_tpu_torch.stereoflow.eval --model /path/weights.pt \\
      --dataset "Kitti15('test')" --save submission metrics [--crop H W] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import time as _time

import numpy as np
import torch

from viewcrafter_tpu_torch.stereoflow.criterion import FlowDatasetMetrics, StereoDatasetMetrics
from viewcrafter_tpu_torch.stereoflow.data import (
    flow_to_color, get_test_datasets_flow, get_test_datasets_stereo, vis_disparity)
from viewcrafter_tpu_torch.stereoflow.engine import tiled_pred

DTYPE = torch.bfloat16  # the model's compute type (the JAX CLI's)


def get_args_parser():
    parser = argparse.ArgumentParser("Test CroCo models on stereo/flow", add_help=False)
    parser.add_argument("--model", required=True, type=str,
                        help="the weights (utils.checkpoint.save_params), beside <model>.json")
    parser.add_argument("--dataset", required=True, type=str,
                        help="test dataset(s), '+'-separated, e.g. \"Kitti15('test')\"")
    parser.add_argument("--task", type=str, default="", choices=["", "stereo", "flow"],
                        help="override the sidecar task")
    parser.add_argument("--tile_conf_mode", type=str, default="",
                        help="confidence weighting (empty = sidecar value)")
    parser.add_argument("--tile_overlap", type=float, default=0.7)
    parser.add_argument("--crop", type=int, nargs=2, default=None,
                        help="tile size H W (default: sidecar, else 352 704)")
    parser.add_argument("--tile_batch", type=int, default=0,
                        help=">0 chunks the tile batch to bound memory")
    parser.add_argument("--save", type=str, nargs="+", default=[],
                        choices=["metrics", "pred", "visu", "err10", "submission"])
    parser.add_argument("--out_dir", type=str, default="",
                        help="output root (default <model>_<dataset>)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the card (cuda), and an error without one")
    return parser


def _state_dict(saved):
    """The weights in what `save_params` wrote: a state dict, a
    `training.TrainState` or a `train_loop.LoopState` (the master weights)."""
    saved = getattr(saved, "train", saved)  # a LoopState's TrainState
    return saved.params if dataclasses.is_dataclass(saved) else saved


def _load_model(model_path: str, task_override: str, device):
    """The downstream model and its settings from the weights file and its
    JSON sidecar (the reference reads these from the checkpoint's args,
    test.py:51-79): (model, task, with_conf, crop, tile_conf_mode)."""
    from viewcrafter_tpu_torch.models.croco_downstream import (
        CroCoDownstreamBinocular, CroCoDownstreamConfig)
    from viewcrafter_tpu_torch.utils.checkpoint import load_params

    meta = {}
    sidecar = model_path.rstrip("/") + ".json"
    if osp.isfile(sidecar):
        with open(sidecar) as fid:
            meta = json.load(fid)
    task = task_override or meta.get("task") or "stereo"
    with_conf = bool(meta.get("with_conf", True))
    crop = tuple(meta.get("crop", (352, 704)))
    tile_conf_mode = meta.get("tile_conf_mode", "conf_expsigmoid_10_5")
    num_channels = {"stereo": 1, "flow": 2}[task] + int(with_conf)
    croco = {k: tuple(v) if isinstance(v, list) else v for k, v in meta.get("croco", {}).items()}
    cfg = CroCoDownstreamConfig(num_channels=num_channels, **croco)
    with torch.device(device):
        model = CroCoDownstreamBinocular(cfg, dtype=DTYPE).eval()
    model.load_state_dict(_state_dict(load_params(osp.abspath(model_path), device="cpu")),
                          strict=True)
    return model, task, with_conf, crop, tile_conf_mode


def _save_batch(pred, gt, pairname, dataset, task, save, outdir, time, submission_dir=None):
    """The artifacts of one sample (test.py:82-126). pred / gt: (H, W, C)
    numpy."""
    fname = osp.join(outdir, dataset.pairname_to_str(pairname))
    os.makedirs(osp.dirname(fname), exist_ok=True)
    if "pred" in save:
        np.save(fname + "_pred.npy", pred)
    if "visu" in save:
        from PIL import Image

        if task == "stereo":
            m = M = None
            if gt is not None:
                finite = gt[np.isfinite(gt)]
                if finite.size:
                    m, M = float(finite.min()), float(finite.max())
            Image.fromarray(vis_disparity(pred[..., 0], m=m, M=M)).save(fname + "_pred.png")
        else:
            ref = gt if gt is not None else pred
            flow_norm = float(np.sqrt(np.sum(ref ** 2, axis=-1)).max())
            Image.fromarray(flow_to_color(pred, maxflow=flow_norm)).save(fname + "_pred.png")
    if "err10" in save:
        from PIL import Image

        assert gt is not None
        l2 = np.sqrt(np.sum((gt - pred) ** 2, axis=-1))
        l2[~np.isfinite(gt[..., 0])] = 0.0
        red = (np.clip(l2, 0, 10.0) * 25.5).astype(np.uint8)[..., None]
        zero = np.zeros_like(red)
        Image.fromarray(np.concatenate([red, zero, zero], axis=2)).save(fname + "_err10.png")
    if "submission" in save:
        assert submission_dir is not None
        pred_np = pred.squeeze(-1) if task == "stereo" else pred
        dataset.submission_save_pairname(pairname, np.ascontiguousarray(pred_np),
                                         submission_dir, time)


def main(args):
    from viewcrafter_tpu_torch.models.lvdm import resolve_device

    device = resolve_device(args.device)
    model, task, with_conf, crop, tile_conf_mode = _load_model(args.model, args.task, device)
    if args.tile_conf_mode:
        tile_conf_mode = args.tile_conf_mode
    if args.crop:
        crop = tuple(args.crop)
    datasets = (get_test_datasets_stereo if task == "stereo"
                else get_test_datasets_flow)(args.dataset)

    all_results = {}
    for i, dataset in enumerate(datasets):
        dstr = args.dataset.split("+")[i]
        outdir = args.out_dir or (
            args.model.rstrip("/") + "_" + dstr.replace("(", "").replace(")", "").replace("'", ""))
        submission_dir = None
        if "submission" in args.save:
            submission_dir = osp.join(
                outdir, f"submission_conf_{tile_conf_mode}_overlap_{args.tile_overlap}")
        metrics = (StereoDatasetMetrics() if task == "stereo"
                   else FlowDatasetMetrics()) if "metrics" in args.save else None
        print(f"evaluating {dataset} ({len(dataset)} pairs) -> {outdir}")

        for idx in range(len(dataset)):
            img1, img2, gt, _pairstr = dataset[idx]
            pairname = dataset.pairnames[idx]
            # Spring's right-frame stereo pairs: flipped so that img1 is the
            # left view, the prediction flipped back (test.py:170-185)
            do_flip = task == "stereo" and dataset.name == "Spring" and "right" in str(pairname)
            sl = slice(None, None, -1 if do_flip else 1)
            b1 = torch.from_numpy(np.ascontiguousarray(img1[:, sl]))[None].to(device)
            b2 = torch.from_numpy(np.ascontiguousarray(img2[:, sl]))[None].to(device)
            bgt = torch.from_numpy(np.asarray(gt))[None].to(device) if gt is not None else None

            t0 = _time.time()
            pred, _, _ = tiled_pred(
                model, b1, b2, None if dataset.name == "Spring" else bgt,
                crop=crop, overlap=args.tile_overlap, conf_mode=tile_conf_mode,
                with_conf=with_conf, tile_batch=args.tile_batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            elapsed = _time.time() - t0
            if do_flip:
                pred = pred.flip(2)

            if metrics is not None and bgt is not None:
                metrics.add_batch(pred, bgt)
            if any(k in args.save for k in ("pred", "visu", "err10", "submission")):
                _save_batch(pred[0].cpu().numpy().astype(np.float32),
                            bgt[0].cpu().numpy() if bgt is not None else None,
                            pairname, dataset, task, args.save, outdir, elapsed,
                            submission_dir=submission_dir)

        if metrics is not None:
            results = metrics.get_results()
            for k, v in results.items():
                print(f"{k:s}: {v:.3f}")
            fname = osp.join(outdir, f"conf_{tile_conf_mode}_overlap_{args.tile_overlap}.json")
            os.makedirs(osp.dirname(fname), exist_ok=True)
            with open(fname, "w") as fid:
                json.dump(results, fid, indent=1)
            print("metrics saved in", fname)
            all_results[str(dataset)] = results
        if "submission" in args.save:
            dataset.finalize_submission(submission_dir)
    return all_results


if __name__ == "__main__":
    main(get_args_parser().parse_args())
