"""Stereo/flow downstream suite (CroCo-Stereo / CroCo-Flow): the port of the
JAX package's `stereoflow/`.

extern/dust3r/croco/stereoflow/ in PyTorch: losses and metrics
(criterion.py), tiled overlapping-crop inference and the train step
(engine.py), the data sets and their augmentations (data.py, augmentor.py)
and the evaluation CLI (eval.py). The ViewCrafter video pipeline does not
use it; it serves the downstream stereo/flow checkpoints.
"""

from viewcrafter_tpu_torch.stereoflow.criterion import (  # noqa: F401
    FlowDatasetMetrics,
    StereoDatasetMetrics,
    flow_metrics,
    l1_loss,
    laplacian_loss,
    laplacian_loss_bounded,
    laplacian_loss_bounded2,
    stereo_metrics,
)
from viewcrafter_tpu_torch.stereoflow.engine import (  # noqa: F401
    make_stereoflow_train_step,
    tiled_pred,
)
