"""Diffusion training in the port against the JAX package, on the CPU:
`viewcrafter_tiny` in float32, every weight leaf non-zero
(`torch_parity.fill_tree`), the JAX side on its XLA path (tests/conftest.py)
and carried across with `convert.convert_tree`.

One JAX compile serves the two parity cases: the JAX package's own
`make_train_step` with `make_optimizer` (a cosine schedule with one warmup
step, so that the first update has lr 0 and the second the peak, and a
global norm above the clip), its optimizer wrapped so that the state also
keeps each step's raw gradients; the port is fed the t and eps that the JAX
step draws from its key (split, randint, normal).

Tolerances, each with its reason:
  - loss: rtol 1e-5 (two float32 programs summing in other orders; 2e-7
    measured);
  - gradients: 2e-5 of the largest JAX gradient, absolute (3e-7 measured
    against 0.10);
  - Adam's moments after two steps: mu 1e-7 absolute (1.2e-8 measured; mu
    is a linear sum of the clipped gradients), nu 1e-10 (3e-12 measured,
    values up to 2e-6);
  - the weights after two steps: where both steps' JAX gradients are at
    least 1e-5 (97% of the elements) within 2e-3 of the learning rate
    (6e-7 measured); everywhere within Adam's bound on two updates,
    2.1 x lr. Adam divides each gradient by its own magnitude, so a
    gradient near rounding noise (this config's GroupNorms hold one channel
    a group, which makes the gradients of the biases before them zero up to
    rounding) is rescaled to a step of up to lr in either package;
  - the schedules: rtol 1e-6 (float32 arithmetic on both sides);
  - EMA: 1e-7 absolute (float32, the same formula);
  - remat: the gradients equal (the same ops recomputed);
  - resume: bit-identical;
  - dp 2 x sp 2 on 4 gloo ranks (`_dryrun.train_on_mesh`): the JAX dry
    run's 2e-5 on the loss and the weights against the single-device step.
The kernel Functions' backward (`_lib.KernelFunction`) runs here with each
kernel's plain twin standing in for the launch: its gradients are the
twin's own.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.config import get_model_config as jax_model_config
from viewcrafter_tpu.models.unet3d import UNet3D as JaxUNet
from viewcrafter_tpu.ops.schedule import DiffusionSchedule as JaxSchedule
from viewcrafter_tpu.train_loop import TrainLoopConfig as JaxLoopConfig
from viewcrafter_tpu.train_loop import make_lr_schedule as jax_lr_schedule
from viewcrafter_tpu.train_loop import make_optimizer as jax_make_optimizer
from viewcrafter_tpu.training import TrainState as JaxTrainState
from viewcrafter_tpu.training import make_train_step as jax_make_train_step
from viewcrafter_tpu.utils import ema as jax_ema
from viewcrafter_tpu_torch import _dryrun
from viewcrafter_tpu_torch.config import get_model_config
from viewcrafter_tpu_torch.convert import convert_tree
from viewcrafter_tpu_torch.models.layers import init_random_
from viewcrafter_tpu_torch.models.unet3d import UNet3D
from viewcrafter_tpu_torch.ops import kernels
from viewcrafter_tpu_torch.ops.kernels import _lib
from viewcrafter_tpu_torch.ops.schedule import DiffusionSchedule
from viewcrafter_tpu_torch.parallel import mesh as pm
from viewcrafter_tpu_torch.train_loop import (
    TrainLoop, TrainLoopConfig, make_lr_schedule, make_optimizer)
from viewcrafter_tpu_torch.training import create_train_state, diffusion_loss, make_train_step
from viewcrafter_tpu_torch.utils import ema as port_ema

NAME = "viewcrafter_tiny"
LOOP = dict(lr=1e-3, warmup_steps=1, decay_steps=4)
B = 2


def _batch(cfg, b=B, seed=1):
    return _dryrun.train_batch(cfg, b, cfg.video_length, seed=seed)


def _port_tree(tree) -> dict:
    return convert_tree(jax.tree.map(np.asarray, tree))


def _jax_draws(key, shape):
    """The t and eps the JAX step draws from `key`, as port tensors."""
    rng_t, rng_eps = jax.random.split(key)
    t = jax.random.randint(rng_t, (shape[0],), 0, 1000)
    eps = jax.random.normal(rng_eps, shape, jnp.float32)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(eps))


@pytest.fixture(scope="module")
def jax_run():
    """Two steps of the JAX package's train step from seeded weights: the
    weights before, each step's loss and raw gradients, the weights and
    Adam's moments after."""
    cfg = jax_model_config(NAME)
    model = JaxUNet(cfg=cfg.unet, dtype=jnp.float32)
    inner = jax_make_optimizer(JaxLoopConfig(**LOOP))
    tx = optax.GradientTransformation(
        lambda p: (jax.tree.map(jnp.zeros_like, p), inner.init(p)),
        lambda g, s, p=None: (lambda u, s2: (u, (g, s2)))(*inner.update(g, s[1], p)))
    h, w = cfg.diffusion.latent_size
    ctx_len = cfg.clip_text.context_length + cfg.resampler.num_queries * cfg.resampler.video_length
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, cfg.video_length, h, w, cfg.unet.in_channels)),
                            jnp.zeros((1,)), jnp.zeros((1, ctx_len, cfg.unet.context_dim)))
    params = tp.fill_tree(shapes, np.random.default_rng(0))
    state = JaxTrainState(params=params, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(model, JaxSchedule.create(), tx)
    batch = _batch(get_model_config(NAME))
    keys = [jax.random.PRNGKey(5), jax.random.PRNGKey(6)]
    losses, grads = [], []
    for key in keys:
        state, loss = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        losses.append(float(loss))
        grads.append(_port_tree(state.opt_state[0]))
    adam = state.opt_state[1][1][0]
    return {"params0": _port_tree(params), "batch": batch, "keys": keys, "losses": losses,
            "grads": grads, "params2": _port_tree(state.params),
            "mu": _port_tree(adam.mu), "nu": _port_tree(adam.nu)}


def _port_model(state_dict, remat=False, loop=LOOP):
    cfg = get_model_config(NAME)
    model = UNet3D(cfg.unet, dtype=torch.float32, remat=remat)
    tx = make_optimizer(TrainLoopConfig(**loop))
    return model, tx, create_train_state(model, cfg, state_dict, tx)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loss_and_gradients_match_jax(jax_run):
    model, _, _ = _port_model(jax_run["params0"])
    batch = _tensors(jax_run["batch"])
    t, eps = _jax_draws(jax_run["keys"][0], batch["latents"].shape)
    loss = diffusion_loss(model, DiffusionSchedule.create(), batch, t, eps)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run["losses"][0], rtol=1e-5)
    ref = jax_run["grads"][0]
    atol = 2e-5 * max(float(g.abs().max()) for g in ref.values())
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=atol, rtol=0,
                                   err_msg=name)


def test_two_optimizer_steps_match_jax(jax_run):
    model, tx, state = _port_model(jax_run["params0"])
    step = make_train_step(model, DiffusionSchedule.create(), tx)
    batch = _tensors(jax_run["batch"])
    for key, ref_loss in zip(jax_run["keys"], jax_run["losses"]):
        t, eps = _jax_draws(key, batch["latents"].shape)
        _, loss, _ = step(state, batch, t=t, eps=eps)
        np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert state.step == 2 and state.opt_state.count == 2
    lr = LOOP["lr"]
    well, total = 0, 0
    for name, ref in jax_run["params2"].items():
        np.testing.assert_allclose(state.opt_state.mu[name], jax_run["mu"][name], atol=1e-7,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(state.opt_state.nu[name], jax_run["nu"][name], atol=1e-10,
                                   rtol=0, err_msg=name)
        err = (state.params[name] - ref).abs()
        assert float(err.max()) <= 2.1 * lr, name
        mask = (jax_run["grads"][0][name].abs() >= 1e-5) & (jax_run["grads"][1][name].abs() >= 1e-5)
        if mask.any():
            assert float(err[mask].max()) <= 2e-3 * lr, name
        well, total = well + int(mask.sum()), total + mask.numel()
    assert well / total > 0.95
    # the module holds the updated master weights
    for name, p in model.named_parameters():
        assert torch.equal(p, state.params[name])


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedules_match_optax(schedule):
    kw = dict(lr=1e-3, warmup_steps=3, decay_steps=10, schedule=schedule)
    port, ref = make_lr_schedule(TrainLoopConfig(**kw)), jax_lr_schedule(JaxLoopConfig(**kw))
    counts = [0, 1, 2, 3, 4, 7, 10, 11, 50]
    np.testing.assert_allclose([float(port(c)) for c in counts],
                               [float(ref(c)) for c in counts], rtol=1e-6, atol=0)
    assert float(port(0)) == 0.0 and float(port(3)) == pytest.approx(1e-3)
    with pytest.raises(ValueError):
        make_lr_schedule(TrainLoopConfig(schedule="step"))


@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_matches_jax(use_num_updates):
    rng = np.random.default_rng(2)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    jstate = jax_ema.ema_init({k: jnp.asarray(v) for k, v in p0.items()}, use_num_updates)
    pstate = port_ema.ema_init({k: torch.from_numpy(v) for k, v in p0.items()}, use_num_updates)
    for _ in range(3):
        p = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        jstate = jax_ema.ema_update(jstate, {k: jnp.asarray(v) for k, v in p.items()}, 0.99)
        port_ema.ema_update(pstate, {k: torch.from_numpy(v) for k, v in p.items()}, 0.99)
    assert pstate.num_updates == int(jstate.num_updates) == (3 if use_num_updates else -1)
    for k in p0:
        np.testing.assert_allclose(port_ema.ema_params(pstate)[k].numpy(),
                                   np.asarray(jax_ema.ema_params(jstate)[k]), atol=1e-7, rtol=0)


def test_remat_gradients_equal_the_gradients_without_it():
    cfg = get_model_config(NAME)
    batch = _tensors(_batch(cfg))
    gen = torch.Generator().manual_seed(4)
    t = torch.tensor([300, 700])
    eps = torch.randn(batch["latents"].shape, generator=gen)
    grads, weights = [], _seeded_state()
    for remat in (False, True):
        model, _, _ = _port_model(weights, remat=remat)
        loss = diffusion_loss(model, DiffusionSchedule.create(), batch, t, eps)
        loss.backward()
        grads.append((float(loss), {n: p.grad for n, p in model.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for name, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][name]), name


def _seeded_state():
    cfg = get_model_config(NAME)
    model = UNet3D(cfg.unet, dtype=torch.float32)
    init_random_(model, torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_remat_is_off_under_the_attention_cache_and_the_shared_prefix():
    """Under remat the cache still collects (remat is off for it) and a
    shared prefix gives the output of the plain call (the dedup is off)."""
    cfg = get_model_config(NAME)
    state = _seeded_state()
    plain, remat = (UNet3D(cfg.unet, dtype=torch.float32, remat=r) for r in (False, True))
    plain.load_state_dict(state)
    remat.load_state_dict(state)
    rng = np.random.default_rng(3)
    h, w = cfg.diffusion.latent_size
    x = torch.from_numpy(rng.standard_normal((1, cfg.video_length, h, w, 8), np.float32))
    x = x.repeat(2, 1, 1, 1, 1)
    ctx = torch.from_numpy(rng.standard_normal((2, 77, cfg.unet.context_dim), np.float32))
    ts = torch.tensor([500.0, 500.0])
    with torch.no_grad():
        y0, cache0 = plain(x, ts, ctx, collect_cache=True)
        y1, cache1 = remat(x, ts, ctx, collect_cache=True)
        assert cache1.keys() == cache0.keys() and len(cache1) > 0
        torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    y2 = remat(x, ts, ctx, shared_prefix=2)
    y3 = remat(x, ts, ctx)
    assert torch.equal(y2, y3)


def test_resume_is_bit_identical(tmp_path):
    """4 uninterrupted steps == 2 steps + checkpoint + 2 resumed steps, bit
    for bit (master weights, Adam's state, EMA, the generator's state), as
    the JAX package's test_training_extras.py holds."""
    cfg = get_model_config(NAME)
    batches = [_tensors(_batch(cfg, 1, seed)) for seed in (3, 4)]

    def loop(ckpt_dir, max_steps):
        return TrainLoop(cfg, TrainLoopConfig(
            lr=1e-3, warmup_steps=1, decay_steps=8, max_steps=max_steps, ckpt_dir=ckpt_dir,
            save_every=2, log_every=0, ema_decay=0.99), device="cpu", dtype=torch.float32)

    a = loop(str(tmp_path / "a"), 4).run(batches, torch.Generator().manual_seed(0))
    loop(str(tmp_path / "b"), 2).run(batches, torch.Generator().manual_seed(0))
    resumed = loop(str(tmp_path / "b"), 4)
    assert resumed.latest_checkpoint().endswith("step_00000002.pt")
    b = resumed.run(batches, torch.Generator().manual_seed(99))  # the checkpoint's generator
    assert a.train.step == b.train.step == 4
    assert a.train.opt_state.count == b.train.opt_state.count == 4
    assert a.ema.num_updates == b.ema.num_updates == 4
    for k in a.train.params:
        assert torch.equal(a.train.params[k], b.train.params[k]), k
        assert torch.equal(a.train.opt_state.mu[k], b.train.opt_state.mu[k]), k
        assert torch.equal(a.train.opt_state.nu[k], b.train.opt_state.nu[k]), k
        assert torch.equal(a.ema.shadow[k], b.ema.shadow[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "step_00000002.pt", "step_00000004.pt"]


def test_log_records_and_lr(tmp_path):
    """The loop runs to max_steps, the weights move, the jsonl log has the
    JAX loop's keys, and its lr values are the JAX schedule's at each
    logged step."""
    cfg = get_model_config(NAME)
    kw = dict(lr=1e-3, warmup_steps=2, decay_steps=20, max_steps=6, schedule="cosine",
              log_every=3, use_ema=False)
    lcfg = TrainLoopConfig(**kw, ckpt_dir=None, log_path=str(tmp_path / "log.jsonl"))
    loop = TrainLoop(cfg, lcfg, device="cpu", dtype=torch.float32)
    init = loop.init_state(torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in init.train.params.items()}
    state = loop.run([_tensors(_batch(cfg, 1, 5))], None, state=init)
    assert state.train.step == 6 and state.ema is None
    assert loop.eval_params(state) is state.train.params
    recs = [json.loads(line) for line in open(tmp_path / "log.jsonl")]
    assert [r["step"] for r in recs] == [3, 6]
    assert all(set(r) == {"step", "loss", "lr", "steps_per_s"} for r in recs)
    assert all(np.isfinite(r["loss"]) for r in recs)
    ref = jax_lr_schedule(JaxLoopConfig(**kw))
    np.testing.assert_allclose([r["lr"] for r in recs], [float(ref(3)), float(ref(6))],
                               rtol=1e-6)
    assert max(float((state.train.params[k] - before[k]).abs().max()) for k in before) > 0


def test_sharded_train_step_on_four_ranks():
    """dp 2 x sp 2 on 4 gloo CPU ranks, remat on: the collectives' backward
    on every rank, then the step's loss and weights against the
    single-device step at the JAX dry run's 2e-5 (`_dryrun.train_dryrun`,
    which raises beyond it)."""
    ranks = pm.spawn(_dryrun.train_on_mesh, 4, "gloo", devices=["cpu"] * 4, args=({},),
                     timeout=300)
    assert all(r["mesh"] == {"dp": 2, "sp": 2, "tp": 1} for r in ranks)
    assert len({r["loss"] for r in ranks}) == 1
    assert ranks[0]["loss_err"] <= _dryrun.ATOL and ranks[0]["weights_err"] <= _dryrun.ATOL


# -- the kernels' backward, with the twins standing in for the launches -------


def _kernel_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    c, i = 16, 32
    return {
        "fullkv_attention": ((r(3, 8, 2, 64), r(3, 12, 2, 64), r(3, 12, 2, 64)), {}),
        "dual_cross_attention": ((r(2, 8, 2, 64), r(2, 5, 2, 64), r(2, 5, 2, 64),
                                  r(2, 7, 2, 64), r(2, 7, 2, 64)), {}),
        "temporal_attention_fused": ((r(1, 5, 3, 2, 64), r(1, 5, 3, 2, 64),
                                      r(1, 5, 3, 2, 64)), {}),
        "temporal_conv3": ((r(2, 4, 6, c), r(c, 3 * c, scale=0.2), r(c)), {}),
        "fused_ff_layer": ((r(10, c), 1 + r(c, scale=0.1), r(c, scale=0.1), r(2 * i, c, scale=0.2),
                            r(2 * i), r(c, i, scale=0.2), r(c)), {"eps": 1e-5}),
        "fused_temporal_layer": ((r(1, 4, 3, c), 1 + r(c, scale=0.1), r(c, scale=0.1),
                                  r(3 * 64, c, scale=0.2), r(c, 64, scale=0.1), r(c)),
                                 {"heads": 1, "dim_head": 64, "eps": 1e-5}),
        "group_norm_fused": ((r(2, 6, 64), 1 + r(64, scale=0.1), r(64, scale=0.1)),
                             {"num_groups": 8, "eps": 1e-5, "with_silu": True}),
    }




@pytest.mark.parametrize("name", list(_kernel_cases()))
def test_kernel_function_backward_is_the_twins_vjp(name):
    """`KernelFunction` (the twin standing in for the launch): the output
    has a grad_fn, every input's gradient is the twin's own (chunked along
    the batch for the attention kernels, one row at a time here),
    `backward_plain` counts the pass and `backward_sites` counts it at the
    site its launch counted, and a launch that bypasses the Function
    raises."""
    from functools import partial

    mod = kernels.KERNEL_MODULES[name]
    args, kw = _kernel_cases()[name]
    twin = partial(getattr(mod, name + "_plain"), **kw)
    chunk = 1 if name in ("fullkv_attention", "dual_cross_attention") else None
    site = ("site",)

    def run(*a):  # the twin, counted at `site` as a launch is
        mod.sites[site] = mod.sites.get(site, 0) + 1
        return twin(*a)

    spec = _lib.KernelSpec(run, twin, mod, chunk)
    kernels.reset_launches()
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = _lib.launch(spec, *leaves)
    assert out.grad_fn is not None
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(out, leaves, gout)
    assert mod.backward_plain == 1
    assert kernels.backward_sites()[name] == {site: 1}
    ref_leaves = [a.clone().requires_grad_(True) for a in args]
    ref = torch.autograd.grad(twin(*ref_leaves), ref_leaves, gout)
    for k, (a, b) in enumerate(zip(got, ref)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=f"input {k}")
    with torch.no_grad():
        assert _lib.launch(spec, *leaves).grad_fn is None  # no grad mode: a plain launch
    with pytest.raises(RuntimeError, match="requires grad"):
        _lib.require(leaves[0], "x", leaves[0].dtype)
    kernels.reset_launches()
