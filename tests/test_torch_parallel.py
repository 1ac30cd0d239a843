"""Multi-device sampling of the port on the CPU: the sharded
`generate_staged` on gloo ranks (`parallel.mesh.spawn`) against the JAX
package's own sharded run on the virtual CPU devices of tests/conftest.py,
and against the port's single-device run, on `viewcrafter_tiny` in float32,
2 DDIM steps, K = 2 CFG:
  - sample dp: batch 2 on 2 ranks (dp 2);
  - CFG-branch dp: batch 1 on 2 ranks, its two guidance branches over dp;
  - dp x sp: batch 2, 4 frames on 4 ranks (dp 2 x sp 2);
then `ViewCrafterPipeline.run_diffusion` with mesh_devices=2 and n_samples=2
against the JAX pipeline's, and the port's own dry run on 4 ranks (its
dp 2 x tp 2 case included; the rest of tensor parallelism is in
tests/test_torch_tp.py).

The JAX draws are carried over as explicit noise (`torch_parity.jax_noise`).
Tolerances: against JAX, the float32 `generate` parity bound of
tests/test_torch_generate.py, 5e-3; against the port's single-device run,
the JAX dry run's 2e-5. The ranks run MKL in its batch-invariant mode and
compute the single-device run in the same process
(`_dryrun.batch_invariant_cpu`): the sharded run then matches it to the bit.
The rank targets live in the port (`viewcrafter_tpu_torch._dryrun`), so the
rank processes import no JAX; every spawn has a timeout of its own.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.parallel.mesh import make_mesh as jax_make_mesh
from viewcrafter_tpu.pipeline import InferenceOptions as JaxOptions
from viewcrafter_tpu.pipeline import ViewCrafterPipeline as JaxPipeline
from viewcrafter_tpu.sampling.ddim import GuidanceConfig as JaxGuidance
from viewcrafter_tpu_torch import _dryrun
from viewcrafter_tpu_torch.config import get_model_config
from viewcrafter_tpu_torch.convert import from_jax_params
from viewcrafter_tpu_torch.parallel import mesh as pm
from viewcrafter_tpu_torch.pipeline import InferenceOptions, ViewCrafterPipeline
from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

STEPS = 2
FS = 10
JAX_TOL = 5e-3
PORT_TOL = 2e-5
SPAWN_TIMEOUT = 300
# name: (batch, ranks)
CASES = {"sample_dp": (2, 2), "cfg_branch_dp": (1, 2), "dp_sp": (2, 4)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = tp.random_params("viewcrafter_tiny", seed=7)
    jeng = tp.JaxEngine(tp.jax_model_config("viewcrafter_tiny"), dtype=jnp.float32)
    cfg = get_model_config("viewcrafter_tiny")
    state = {n: {k: v.numpy() for k, v in sd.items()}
             for n, sd in from_jax_params(params).items()}
    cpus = jax.local_devices(backend="cpu")
    rng = np.random.default_rng(8)
    jax_videos, runs = {}, {}
    for i, (name, (b, world)) in enumerate(CASES.items()):
        frames = rng.uniform(-1, 1, (b, cfg.video_length, cfg.height, cfg.width, 3)
                             ).astype(np.float32)
        ids = np.repeat(tp.fixed_prompt_ids(6), b, 0)
        uids = np.repeat(tp.fixed_prompt_ids(0), b, 0)
        key = jax.random.PRNGKey(11 + i)
        jax_videos[name] = np.asarray(jeng.generate_staged(
            params, jnp.asarray(frames), jnp.asarray(ids), jnp.asarray(uids), key,
            steps=STEPS, guidance=JaxGuidance(), fs=FS, chunk=STEPS,
            mesh=jax_make_mesh(world, devices=cpus[:world])), np.float32)
        noise = tp.jax_noise(key, frames.shape, STEPS, cfg.vae.z_channels,
                             cfg.vae.downsample_factor)
        runs[name] = _dryrun.Run(
            frames, ids.astype(np.int64), uids.astype(np.int64),
            tuple(a.numpy() for a in (noise.x_T, noise.steps, noise.posterior)),
            dict(steps=STEPS, guidance=GuidanceConfig(), fs=FS, chunk=STEPS), {})
    port = {}
    for world in sorted({w for _, w in CASES.values()}):
        names = [n for n, (_, w) in CASES.items() if w == world]
        results = pm.spawn(_dryrun.generate_on_mesh, world, "gloo", devices=["cpu"] * world,
                           args=(cfg, state, [runs[n] for n in names]), timeout=SPAWN_TIMEOUT)
        for j, name in enumerate(names):
            port[name] = [r[j] for r in results]
    return {"params": params, "jeng": jeng, "state": state, "cfg": cfg, "jax": jax_videos,
            "port": port, "tmp": tmp_path_factory.mktemp("parallel")}


@pytest.mark.parametrize("case", CASES)
def test_sharded_generate_matches_jax(setup, case):
    got, _ = setup["port"][case][0]
    ref = setup["jax"][case]
    assert got.shape == ref.shape == (CASES[case][0], 4, 32, 64, 3)
    assert np.abs(ref).mean() > 1e-2
    assert tp.max_err(got, ref) <= JAX_TOL


@pytest.mark.parametrize("case", CASES)
def test_sharded_generate_matches_single_device(setup, case):
    """Every rank returns the whole video, the same on each, within 2e-5 of
    the single-device run (here to the bit)."""
    per_rank = setup["port"][case]
    got, single = per_rank[0]
    assert len(per_rank) == CASES[case][1]
    assert all(np.array_equal(v, got) for v, _ in per_rank[1:])
    assert single is not None and single.shape == got.shape
    assert tp.max_err(got, single) <= PORT_TOL


def test_sharded_run_diffusion_matches_jax_pipeline(setup):
    """mesh_devices=2, n_samples=2: the two samples as one sharded batch in
    both packages, sample 0 returned, sample 1 written by rank 0. The prompt
    is empty (text_input=False): the tokenizers' hash fallback would draw
    other ids in the rank processes."""
    out = setup["tmp"]
    common = dict(model="viewcrafter_tiny", dust3r_model="dust3r_tiny", ddim_steps=STEPS,
                  n_samples=2, mesh_devices=2, text_input=False, frame_stride=FS,
                  weights_dtype="fp32", seed=123)
    jp = JaxPipeline(JaxOptions(out_dir=str(out / "jax"), exp_name="p", **common),
                     init_models=False)
    jp.engine = setup["jeng"]
    jp.lvdm_params = setup["params"]
    os.makedirs(jp.opts.save_dir, exist_ok=True)
    cfg = setup["cfg"]
    frames01 = np.random.default_rng(9).uniform(
        0, 1, (cfg.video_length, cfg.height, cfg.width, 3)).astype(np.float32)
    ref = np.asarray(jp.run_diffusion(frames01), np.float32)
    # the JAX pipeline's draws for its one sharded call
    _, sub = jax.random.split(jax.random.PRNGKey(123))
    noise = tp.jax_noise(sub, (2,) + frames01.shape, STEPS, cfg.vae.z_channels,
                         cfg.vae.downsample_factor)
    opts = InferenceOptions(out_dir=str(out / "port"), exp_name="p", **common)
    results = pm.spawn(_dryrun.diffuse_on_mesh, 2, "gloo", devices=["cpu"] * 2,
                       args=(opts, setup["state"], frames01,
                             tuple(a.numpy() for a in (noise.x_T, noise.steps,
                                                       noise.posterior))),
                       timeout=SPAWN_TIMEOUT)
    (video, files), (video1, _) = results
    assert video.shape == ref.shape == frames01.shape
    assert np.array_equal(video, video1)
    assert tp.max_err(video, ref) <= JAX_TOL
    assert any(f.startswith("diffusion_sample1") for f in files)


def test_port_dryrun_on_four_ranks():
    """`python -m viewcrafter_tpu_torch._dryrun 4`: sample dp, CFG-branch dp,
    frame sp and dp 2 x tp 2 (CFG-branch dp with the UNet's heads and
    channels over tp, in float64) on gloo CPU ranks, each within 2e-5 of
    single-device."""
    errs = _dryrun.inference_dryrun(4, timeout=SPAWN_TIMEOUT)
    assert set(errs) == {"sample_dp", "cfg_branch_dp", "frame_sp", "dp_sp_tp"}
    assert all(e <= PORT_TOL for e in errs.values())


def test_tensor_parallelism_and_a_small_group_raise():
    """Tensor parallelism is ported (tests/test_torch_tp.py): a tp mesh that
    does not factor the device count raises, and a pipeline with mesh_tp = 2
    gets as far as the missing process group."""
    opts = dict(model="viewcrafter_tiny", dust3r_model="dust3r_tiny")
    with pytest.raises(ValueError, match="cannot factor"):
        pm.make_mesh(2, dp=1, tp=3)
    with pytest.raises(RuntimeError, match="torchrun"):
        ViewCrafterPipeline(InferenceOptions(mesh_devices=2, mesh_tp=2, **opts),
                            init_models=False, device="cpu")
    # no process group: one rank, fewer than mesh_devices
    with pytest.raises(RuntimeError, match="torchrun"):
        ViewCrafterPipeline(InferenceOptions(mesh_devices=2, **opts), init_models=False,
                            device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        pm.make_mesh(2, devices=["cpu", "cpu"])
