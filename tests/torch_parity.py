"""Shared helpers of the port's parity tests (tests/test_torch_*.py): seeded
numpy weights for every leaf of a JAX parameter tree, the JAX and port
engines and pipelines built from them, and the JAX package's noise chain
rebuilt as plain arrays for the port's explicit-noise argument."""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from viewcrafter_tpu.config import get_model_config as jax_model_config
from viewcrafter_tpu.models.dust3r import Dust3rModel as JaxDust3r
from viewcrafter_tpu.models.lvdm import LVDMParams
from viewcrafter_tpu.models.lvdm import VideoDiffusionEngine as JaxEngine
from viewcrafter_tpu.pipeline import ViewCrafterPipeline as JaxPipeline
from viewcrafter_tpu_torch.config import get_model_config
from viewcrafter_tpu_torch.convert import dust3r_from_jax_params, from_jax_params
from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, GenerateNoise, VideoDiffusionEngine
from viewcrafter_tpu_torch.parallel.mesh import Axis
from viewcrafter_tpu_torch.parallel.tp import shard_unet_
from viewcrafter_tpu_torch.pipeline import ViewCrafterPipeline

# torch's CPU threads stay modest: the suite runs in several workers at once
torch.set_num_threads(2)


def fill_tree(tree, rng: np.random.Generator):
    """Every leaf of a (shape) tree filled from `rng`, none zero: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), every other vector
    N(0, 0.05^2), every other matrix N(0, 1/width)."""
    def fill(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = tuple(leaf.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return z * np.float32(np.prod(shape[:-1]) ** -0.5)
        if name == "scale":
            return 1.0 + 0.1 * z
        if len(shape) == 1:
            return 0.05 * z
        return z * np.float32(shape[-1] ** -0.5)

    return jax.tree_util.tree_map_with_path(fill, tree)


def random_params(name: str, seed: int = 0) -> LVDMParams:
    """Numpy weights for every leaf of the JAX engine's tree for preset
    `name` (shapes from eval_shape: no init forward pass runs)."""
    eng = JaxEngine(jax_model_config(name), dtype=jnp.float32)
    shapes = jax.eval_shape(eng.init_params, jax.random.PRNGKey(0))
    return fill_tree(shapes, np.random.default_rng(seed))


def engines(name: str, params: LVDMParams, jax_dtype, torch_dtype):
    """(JAX engine, port engine on the CPU), both holding `params`."""
    jeng = JaxEngine(jax_model_config(name), dtype=jax_dtype)
    teng = VideoDiffusionEngine(get_model_config(name), dtype=torch_dtype, device="cpu")
    teng.load_params(from_jax_params(params))
    return jeng, teng


def jax_noise(rng, frames_shape, steps: int, z_channels: int, factor: int) -> GenerateNoise:
    """The draws `VideoDiffusionEngine.generate` of the JAX package makes
    from `rng`, as port tensors: split(rng, 3) -> (z, noise, sample); x_T
    from the noise key; step i from fold_in(sample, i); each frame's
    posterior from the per-frame split carry of `encode_frames`."""
    b, t, hh, ww = frames_shape[:4]
    shape = (b, t, hh // factor, ww // factor, z_channels)
    rng_z, rng_noise, rng_sample = jax.random.split(rng, 3)
    x_t = jax.random.normal(rng_noise, shape, jnp.float32)
    step = [jax.random.normal(jax.random.fold_in(rng_sample, i), shape, jnp.float32)
            for i in range(steps)]
    post, carry = [], rng_z
    for _ in range(t):
        carry, sub = jax.random.split(carry)
        post.append(jax.random.normal(sub, (b,) + shape[2:], jnp.float32))
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return GenerateNoise(x_T=as_t(x_t), steps=as_t(np.stack(step)),
                         posterior=as_t(np.stack(post, axis=1)))


def fixed_prompt_ids(n_words: int, seed: int = 0) -> np.ndarray:
    """Token ids of an `n_words`-word prompt as `prompt_ids` returns them,
    (1, 77) int32 with SOT first, EOT after the words and zeros after that,
    but the same in every process: the words' ids are drawn from
    default_rng(seed) in the hash fallback's range [1000, 49000). (Without a
    BPE file both packages' tokenizers take Python's salted `hash`, so their
    ids change from one process to the next.)"""
    words = np.random.default_rng(seed).integers(1000, 49000, n_words)
    out = np.zeros((1, 77), np.int32)
    out[0, :n_words + 2] = [49406, *words, 49407]
    return out


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


class JaxPipelineF32(JaxPipeline):
    """The JAX pipeline with its two networks built in float32 (its
    constructor builds them in bf16): the same programs, jitted as there.
    DUSt3R holds the weights `setup_models` draws with float32 storage, the
    diffusion stack `random_params(seed=5)` (every leaf non-zero), so the
    diffusion stack's own init, a compile of its own, is skipped."""

    def __init__(self, opts):
        assert opts.weights_dtype == "fp32"
        super().__init__(opts, init_models=False)
        self.engine = JaxEngine(self.model_cfg, dtype=jnp.float32)
        self.dust3r = JaxDust3r(cfg=self.dust3r_cfg, dtype=jnp.float32)
        self._dust3r_encode = jax.jit(
            functools.partial(self.dust3r.apply, method=JaxDust3r.encode),
            static_argnames=("is_portrait",))
        self._dust3r_decode = jax.jit(
            functools.partial(self.dust3r.apply, method=JaxDust3r.decode_pairs),
            static_argnames=("h", "w", "is_portrait1", "is_portrait2"))
        rng_d = jax.random.split(self.rng)[0]
        self.dust3r_params = jax.jit(self.dust3r.init)(
            rng_d, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3)))
        params = random_params(opts.model, seed=5)
        self.lvdm_params = LVDMParams(**{k: jax.tree.map(jnp.asarray, getattr(params, k))
                                         for k in SUBMODELS})


def pipelines_f32(jax_opts, port_opts):
    """(JaxPipelineF32, the port's pipeline on the CPU in float32), both
    holding the same weights."""
    jp = JaxPipelineF32(jax_opts)
    tpipe = ViewCrafterPipeline(port_opts, init_models=False, device="cpu", dtype=torch.float32)
    tpipe.load_params(dust3r_from_jax_params(numpy_tree(jp.dust3r_params)),
                      from_jax_params({k: numpy_tree(getattr(jp.lvdm_params, k))
                                       for k in SUBMODELS}))
    return jp, tpipe


@dataclasses.dataclass(frozen=True)
class ThreadAxis(Axis):
    """A "tp" axis whose ranks are threads of this process: `sum` adds the
    threads' partials in index order (`run_tp_threads`), in place of the
    all-reduce of a process group."""

    exchange: object = None

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.exchange.sum(self.index, x)


class _Exchange:
    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.parts = [None] * n

    def sum(self, i: int, x: torch.Tensor) -> torch.Tensor:
        self.parts[i] = x
        self.barrier.wait()
        total = self.parts[0]
        for part in self.parts[1:]:
            total = total + part
        self.barrier.wait()  # every thread has read the parts before the next sum
        return total


def run_tp_threads(fn, size: int, timeout: float = 120.0) -> list:
    """fn(axis) for each index of a `size`-wide ThreadAxis, each in a thread
    of its own under no_grad; the results in index order. A thread that
    raises breaks the others' barrier and the call raises its error."""
    ex = _Exchange(size, timeout)

    def run(i):
        try:
            with torch.no_grad():
                return fn(ThreadAxis(None, size, i, ex))
        except BaseException:
            ex.barrier.abort()
            raise

    with concurrent.futures.ThreadPoolExecutor(size) as pool:
        futures = [pool.submit(run, i) for i in range(size)]
    errors = [f.exception() for f in futures if f.exception() is not None]
    if errors:  # the cause, not the barrier it broke in the other threads
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return [f.result() for f in futures]


def shard_copies(module: torch.nn.Module, size: int) -> list:
    """`size` copies of `module`, copy i cut to index i of a `size`-wide
    "tp" axis (`parallel/tp.py`); the axis is set per call (`set_axis`)."""
    return [shard_unet_(copy.deepcopy(module), Axis(None, size, i)) for i in range(size)]


def set_axis(module: torch.nn.Module, axis: Axis) -> torch.nn.Module:
    """Point every split module of a cut `module` at `axis`."""
    for mod in module.modules():
        if "tp" in vars(mod):
            mod.tp = axis
    return module
