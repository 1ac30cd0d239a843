"""Plain PyTorch reference of ViewCrafter's diffusion stage, in float32.

An implementation of the published architecture (the released
`configs/inference_pvd_1024.yaml` / `_512.yaml` networks: the 3D UNet, the
KL-VAE, OpenCLIP ViT-H/14 text and vision towers, the Perceiver resampler,
DDIM with v-prediction, classifier-free guidance and its rescale) with no
kernel, no cache of the program's, no batching trick and no import of the
program. Its parameter names are the program's state-dict keys, so that one
set of weights made by the benchmark loads into both.

Every product goes through `numerics.Numerics`, which computes in float32
(TF32 off) or, for the control, rounds both operands to a lower precision
first.
"""
