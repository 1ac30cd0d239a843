"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU unasked."""

import subprocess
import sys

import pytest
import torch

_PROBE = """
import sys
import viewcrafter_tpu_torch
import viewcrafter_tpu_torch.align.global_align
import viewcrafter_tpu_torch.align.pairs
import viewcrafter_tpu_torch.align.rotations
import viewcrafter_tpu_torch.app
import viewcrafter_tpu_torch.cli
import viewcrafter_tpu_torch.convert
import viewcrafter_tpu_torch.geometry.trajectory
import viewcrafter_tpu_torch.geometry.transforms
import viewcrafter_tpu_torch.models.dust3r
import viewcrafter_tpu_torch.models.lvdm
import viewcrafter_tpu_torch.ops.kernels
import viewcrafter_tpu_torch.ops.rasterize
import viewcrafter_tpu_torch.ops.resize
import viewcrafter_tpu_torch.ops.rope2d
import viewcrafter_tpu_torch.pipeline
import viewcrafter_tpu_torch.utils.io
import viewcrafter_tpu_torch.utils.metrics
import viewcrafter_tpu_torch.utils.viz
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "viewcrafter_tpu"))
print(",".join(bad))
# the card's machine has no PIL, imageio or matplotlib: nothing imported
# with the port may need them
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("PIL", "imageio", "matplotlib"))))
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
    import dataclasses

    from viewcrafter_tpu_torch.config import get_model_config
    from viewcrafter_tpu_torch.models.unet3d import UNet3D

    base = get_model_config("viewcrafter_tiny").unet
    for flag in ("use_causal_attention", "use_relative_position"):
        with pytest.raises(NotImplementedError):
            UNet3D(dataclasses.replace(base, **{flag: True}))
