"""The port's loader of the released checkpoints (`utils/checkpoint.py`)
against the JAX package's translator, the independent spec of the
reference's names and layouts.

Port weights drawn from a seed are written under the reference's names by
`*_to_reference`. The JAX translator must then take every key and give a
tree whose shapes are those of the JAX model's init, and
`convert.from_jax_params` of that tree must equal the source; the port's own
`*_from_reference` must equal it too. Every comparison is exact (float32
leaves, or bf16-valued leaves widened to float32): loading moves weights, it
computes nothing.

The JAX translator reads a leaf with `.numpy()`, which a bfloat16 tensor does
not have, so a bfloat16 file is held against the JAX package reading the same
(bf16-rounded) values from a float32 file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viewcrafter_tpu.config import Dust3rConfig as JaxDust3rConfig
from viewcrafter_tpu.config import get_model_config as jax_model_config
from viewcrafter_tpu.models.dust3r import Dust3rModel as JaxDust3r
from viewcrafter_tpu.models.lvdm import VideoDiffusionEngine as JaxEngine
from viewcrafter_tpu.pipeline import InferenceOptions as JaxOptions
from viewcrafter_tpu.pipeline import ViewCrafterPipeline as JaxPipeline
from viewcrafter_tpu.utils import checkpoint as jck
from viewcrafter_tpu_torch.config import Dust3rConfig, get_dust3r_config, get_model_config
from viewcrafter_tpu_torch.convert import dust3r_from_jax_params, from_jax_params
from viewcrafter_tpu_torch.models.dust3r import Dust3rModel
from viewcrafter_tpu_torch.models.layers import init_random_
from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, VideoDiffusionEngine
from viewcrafter_tpu_torch.pipeline import InferenceOptions, ViewCrafterPipeline
from viewcrafter_tpu_torch.utils import checkpoint as ck

TINY_DUST3R = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=2, dec_embed_dim=32,
                   dec_depth=4, dec_num_heads=2, dpt_feature_dim=16,
                   dpt_hidden_dims=(8, 8, 16, 32))


def _port_lvdm_state(cfg, seed: int) -> dict:
    eng = VideoDiffusionEngine(cfg, dtype=torch.float32, device="cpu")
    eng.init_params(seed=seed)
    return {n: {k: v.clone() for k, v in getattr(eng, n).state_dict().items()} for n in SUBMODELS}


def _port_dust3r_state(cfg, seed: int, shared_decoder: bool) -> dict:
    """Seeded port DUSt3R weights; shared_decoder: the second decoder a copy
    of the first, as a file without `dec_blocks2` loads."""
    model = Dust3rModel(cfg, dtype=torch.float32)
    init_random_(model, torch.Generator().manual_seed(seed))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    if shared_decoder:
        for k in list(state):
            if ".block2_" in k:
                state[k] = state[k.replace(".block2_", ".block1_")].clone()
    return state


def _assert_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k in want:
        a, b = got[k].float(), want[k].float()
        assert a.shape == b.shape and torch.equal(a, b), k


def _lvdm_configs(rel_pos: bool):
    port, jax_cfg = get_model_config("viewcrafter_tiny"), jax_model_config("viewcrafter_tiny")
    if rel_pos:
        port = dataclasses.replace(port, unet=dataclasses.replace(
            port.unet, use_relative_position=True))
        jax_cfg = dataclasses.replace(jax_cfg, unet=dataclasses.replace(
            jax_cfg.unet, use_relative_position=True))
    return port, jax_cfg


@pytest.mark.parametrize("rel_pos", [False, True], ids=["plain", "relative_position"])
def test_lvdm_loader_matches_the_jax_translator(rel_pos):
    cfg, jcfg = _lvdm_configs(rel_pos)
    state = _port_lvdm_state(cfg, seed=3)
    ref = ck.lvdm_to_reference(state, cfg)
    assert any(".relative_position_k.embeddings_table" in k for k in ref) == rel_pos
    # init_attn's projections in the reference's Conv1d form
    assert ref["model.diffusion_model.init_attn.0.proj_in.weight"].ndim == 3

    sd = jck.normalize_lvdm_state_dict(ref)
    used = set()
    for fn in (lambda t: jck.map_unet(t, cfg=jcfg.unet), lambda t: jck.map_vae(t, cfg=jcfg.vae),
               lambda t: jck.map_clip_text(t, layers=jcfg.clip_text.layers),
               lambda t: jck.map_clip_vision(t, layers=jcfg.clip_vision.layers),
               lambda t: jck.map_resampler(t, depth=jcfg.resampler.depth)):
        tr = jck.Translator(sd)
        fn(tr)
        used |= tr.used
    assert used == set(sd), sorted(set(sd) - used)[:10]

    trees = jck.translate_lvdm_checkpoint(ref, jcfg)
    shapes = jax.eval_shape(JaxEngine(jcfg, dtype=jnp.float32).init_params, jax.random.PRNGKey(0))
    for name in SUBMODELS:
        errs = jck.verify_tree_shapes(trees[name], getattr(shapes, name))
        assert not errs, (name, errs[:10])
    via_jax = from_jax_params(trees)
    ours = ck.lvdm_from_reference(ref, cfg)
    for name in SUBMODELS:
        _assert_equal(via_jax[name], state[name])
        _assert_equal(ours[name], state[name])


def test_dust3r_loader_matches_the_jax_translator():
    cfg, jcfg = Dust3rConfig(**TINY_DUST3R), JaxDust3rConfig(**TINY_DUST3R)
    state = _port_dust3r_state(cfg, seed=4, shared_decoder=True)
    ref = ck.dust3r_to_reference(state, cfg)
    raw = {"model": {k: v for k, v in ref.items() if not k.startswith("dec_blocks2.")},
           "args": "AsymmetricCroCo3DStereo(...)"}
    sd = jck.normalize_dust3r_state_dict(raw)
    tr = jck.Translator(sd)
    jck.map_dust3r(tr, cfg=jcfg)
    assert tr.used == set(sd), sorted(set(sd) - tr.used)[:10]

    tree = jck.translate_dust3r_checkpoint(raw, jcfg)
    shapes = jax.eval_shape(JaxDust3r(cfg=jcfg, dtype=jnp.float32).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3)))
    errs = jck.verify_tree_shapes(tree["params"], shapes["params"])
    assert not errs, errs[:10]
    _assert_equal(dust3r_from_jax_params(tree), state)
    _assert_equal(ck.dust3r_from_reference(raw, cfg), state)


def test_loader_quirks_and_strictness():
    cfg, _ = _lvdm_configs(False)
    state = _port_lvdm_state(cfg, seed=5)
    ref = ck.lvdm_to_reference(state, cfg)
    fps = "model.diffusion_model.fps_embedding.0.weight"
    proj = "model.diffusion_model.input_blocks.1.1.proj_in.weight"  # a body Linear
    legacy = {k.replace("fps_embedding", "framestride_embed"): v for k, v in ref.items()}
    legacy[proj] = legacy[proj][:, :, None]  # an (out, in, 1) Conv1d weight
    legacy["model.diffusion_model.unused_buffer"] = torch.zeros(3)  # ignored
    assert fps not in legacy
    for raw in ({"state_dict": legacy}, {"state_dict": {"module": {
            f"module.{k}": v for k, v in legacy.items()}}}):
        out = ck.lvdm_from_reference(raw, cfg)
        for name in SUBMODELS:
            _assert_equal(out[name], state[name])

    time = "model.diffusion_model.time_embed.2.weight"
    with pytest.raises(ValueError, match=r"missing: time_embed_2\.weight \(checkpoint key "
                                         r"model\.diffusion_model\.time_embed\.2\.weight\)"):
        ck.lvdm_from_reference({k: v for k, v in ref.items() if k != time}, cfg)
    with pytest.raises(ValueError, match=r"unfilled: fps_embed_0\.weight"):  # an optional map
        ck.lvdm_from_reference({k: v for k, v in ref.items() if k != fps}, cfg)
    wrong = dict(ref, **{proj: ref[proj][:, :-1]})
    with pytest.raises(ValueError, match=r"shape down_0_0_spatial\.proj_in\.weight"):
        ck.lvdm_from_reference(wrong, cfg)
    with pytest.raises(ValueError, match="dtype"):
        ck.lvdm_from_reference(dict(ref, **{fps: ref[fps].long()}), cfg)

    dcfg = Dust3rConfig(**TINY_DUST3R)
    dref = ck.dust3r_to_reference(_port_dust3r_state(dcfg, seed=6, shared_decoder=False), dcfg)
    del dref["downstream_head2.dpt.head.4.bias"]
    with pytest.raises(ValueError, match=r"head2\.head_conv3\.bias"):
        ck.dust3r_from_reference({"model": dref}, dcfg)


@pytest.mark.parametrize("kind", ["lvdm", "dust3r"])
def test_full_width_names_survive_the_round_trip(kind):
    """At viewcrafter_25 and dust3r_512, on the meta device and without JAX:
    every name and shape comes back."""
    if kind == "lvdm":
        cfg = get_model_config("viewcrafter_25")
        shapes = ck.lvdm_param_shapes(cfg)
        state = {n: {k: torch.empty(s, device="meta") for k, s in d.items()}
                 for n, d in shapes.items()}
        back = ck.lvdm_from_reference({"state_dict": ck.lvdm_to_reference(state, cfg)}, cfg, shapes)
        got = {n: {k: v.shape for k, v in d.items()} for n, d in back.items()}
    else:
        cfg = get_dust3r_config("dust3r_512")
        shapes = ck.dust3r_param_shapes(cfg)
        ref = ck.dust3r_to_reference({k: torch.empty(s, device="meta")
                                      for k, s in shapes.items()}, cfg)
        got = {k: v.shape for k, v in ck.dust3r_from_reference({"model": ref}, cfg).items()}
    assert got == shapes


FIXTURE = dict(model="viewcrafter_tiny", dust3r_model="dust3r_tiny", video_length=4,
               dust3r_size=64, niter=5, ddim_steps=2)


@pytest.fixture(scope="module")
def checkpoint_files(tmp_path_factory):
    """Tiny checkpoints on disk in the released containers: float32 leaves,
    bf16 leaves, and float32 leaves holding the bf16 values."""
    tmp = tmp_path_factory.mktemp("ckpt")
    cfg, dcfg = get_model_config("viewcrafter_tiny"), get_dust3r_config("dust3r_tiny")
    lvdm = ck.lvdm_to_reference(_port_lvdm_state(cfg, seed=7), cfg)
    dust3r = ck.dust3r_to_reference(_port_dust3r_state(dcfg, seed=8, shared_decoder=False), dcfg)
    files = {}
    for kind, cast in (("fp32", lambda v: v), ("bf16", lambda v: v.to(torch.bfloat16)),
                       ("bf16_as_fp32", lambda v: v.to(torch.bfloat16).float())):
        files[kind] = (str(tmp / f"model_{kind}.ckpt"), str(tmp / f"dust3r_{kind}.pth"))
        torch.save({"state_dict": {k: cast(v) for k, v in lvdm.items()}}, files[kind][0])
        torch.save({"model": {k: cast(v) for k, v in dust3r.items()}, "args": "dust3r"},
                   files[kind][1])
    return files


def _jax_loaded(jp) -> tuple:
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (dust3r_from_jax_params(np_tree(jp.dust3r_params)),
            from_jax_params({n: np_tree(getattr(jp.lvdm_params, n)) for n in SUBMODELS}))


@pytest.mark.parametrize("storage", ["fp32", "bf16"])
def test_pipelines_load_the_same_weights(checkpoint_files, storage, tmp_path, monkeypatch):
    """Both packages' pipelines load the tiny files: float32 storage from the
    float32 file, bf16 storage from the bf16 file (the JAX package from the
    float32 file of the same values). The loaded weights agree exactly. With
    no BPE file, a diffusion run then raises in both."""
    monkeypatch.delenv("VIEWCRAFTER_BPE_PATH", raising=False)
    monkeypatch.chdir(tmp_path)  # no ./checkpoints/ with a merges file
    port_file = checkpoint_files[storage]
    jax_file = checkpoint_files["fp32" if storage == "fp32" else "bf16_as_fp32"]
    kw = dict(FIXTURE, weights_dtype=storage, out_dir=str(tmp_path))
    jp = JaxPipeline(JaxOptions(ckpt_path=jax_file[0], model_path=jax_file[1], **kw))
    tpipe = ViewCrafterPipeline(InferenceOptions(ckpt_path=port_file[0], model_path=port_file[1],
                                                 **kw), device="cpu",
                                dtype=torch.float32 if storage == "fp32" else torch.bfloat16)
    assert tpipe.loaded_real_ckpt
    dust3r, lvdm = _jax_loaded(jp)
    _assert_equal(tpipe.dust3r.state_dict(), dust3r)
    for name in SUBMODELS:
        _assert_equal(getattr(tpipe.engine, name).state_dict(), lvdm[name])
    frames = np.zeros((4, 32, 64, 3), np.float32)
    with pytest.raises(FileNotFoundError):
        jp.run_diffusion(frames)
    with pytest.raises(FileNotFoundError):
        tpipe.run_diffusion(frames)
