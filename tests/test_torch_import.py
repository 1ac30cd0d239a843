"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU unasked."""

import subprocess
import sys

import pytest
import torch

_PROBE = """
import sys
import viewcrafter_tpu_torch
import viewcrafter_tpu_torch._dryrun
import viewcrafter_tpu_torch.align.global_align
import viewcrafter_tpu_torch.align.pairs
import viewcrafter_tpu_torch.align.rotations
import viewcrafter_tpu_torch.app
import viewcrafter_tpu_torch.cli
import viewcrafter_tpu_torch.convert
import viewcrafter_tpu_torch.data.co3d
import viewcrafter_tpu_torch.data.datasets
import viewcrafter_tpu_torch.data.synth_multiview
import viewcrafter_tpu_torch.data.video_reader
import viewcrafter_tpu_torch.geometry.trajectory
import viewcrafter_tpu_torch.geometry.transforms
import viewcrafter_tpu_torch.models.croco_downstream
import viewcrafter_tpu_torch.models.croco_pretrain
import viewcrafter_tpu_torch.models.dust3r
import viewcrafter_tpu_torch.models.dust3r_losses
import viewcrafter_tpu_torch.models.lvdm
import viewcrafter_tpu_torch.ops.kernels
import viewcrafter_tpu_torch.ops.rasterize
import viewcrafter_tpu_torch.ops.resize
import viewcrafter_tpu_torch.ops.rope2d
import viewcrafter_tpu_torch.parallel
import viewcrafter_tpu_torch.parallel.mesh
import viewcrafter_tpu_torch.pipeline
import viewcrafter_tpu_torch.pretrain
import viewcrafter_tpu_torch.stereoflow
import viewcrafter_tpu_torch.stereoflow.augmentor
import viewcrafter_tpu_torch.stereoflow.criterion
import viewcrafter_tpu_torch.stereoflow.data
import viewcrafter_tpu_torch.stereoflow.engine
import viewcrafter_tpu_torch.stereoflow.eval
import viewcrafter_tpu_torch.train_loop
import viewcrafter_tpu_torch.training
import viewcrafter_tpu_torch.utils.checkpoint
import viewcrafter_tpu_torch.utils.ema
import viewcrafter_tpu_torch.utils.io
import viewcrafter_tpu_torch.utils.metrics
import viewcrafter_tpu_torch.utils.profiling
import viewcrafter_tpu_torch.utils.viz
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "viewcrafter_tpu"))
print(",".join(bad))
# the card's machine has no PIL, imageio, matplotlib, cv2 or h5py: nothing
# imported with the port may need them
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("PIL", "imageio", "matplotlib", "cv2", "h5py"))))
"""


def test_import_pulls_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         check=True, timeout=120)
    no_jax, no_image_libs = (out.stdout + "\n").split("\n")[:2]
    assert no_jax.strip() == "", no_jax
    assert no_image_libs.strip() == "", no_image_libs


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from viewcrafter_tpu_torch.config import get_model_config
    from viewcrafter_tpu_torch.models.lvdm import VideoDiffusionEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_model_config("viewcrafter_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoDiffusionEngine(cfg)
    eng = VideoDiffusionEngine(cfg, device="cpu")
    assert eng.device.type == "cpu"


def test_unported_options_raise():
    # the causal mask, the relative-position bias (tests/test_torch_relpos.py),
    # multi-device sampling over dp and sp (tests/test_torch_parallel.py) and
    # tensor parallelism (tests/test_torch_tp.py) are ported: the CLI and the
    # pipeline take mesh_tp, and without a process group of mesh_devices
    # ranks only the missing group raises
    import dataclasses

    from viewcrafter_tpu_torch.cli import get_parser, opts_from_args
    from viewcrafter_tpu_torch.pipeline import ViewCrafterPipeline

    opts = opts_from_args(get_parser().parse_args(
        ["--image_dir", "test/images/fruit.png", "--model", "viewcrafter_tiny",
         "--dust3r_model", "dust3r_tiny", "--mesh_devices", "2", "--mesh_tp", "2"]))
    assert (opts.mesh_devices, opts.mesh_tp) == (2, 2)
    with pytest.raises(RuntimeError, match="torchrun"):
        ViewCrafterPipeline(opts, init_models=False, device="cpu")
    pipe = ViewCrafterPipeline(dataclasses.replace(opts, mesh_devices=0), init_models=False,
                               device="cpu")
    assert pipe._sample_mesh(1) is None  # one device: the serial loop
