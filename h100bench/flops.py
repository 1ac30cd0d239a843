"""The arithmetic the benchmark holds the program to: the model FLOPs of a
video, from a walk of the published architecture at the configuration's
sizes, and the operations and bytes of one call of each hand-written kernel,
from the function it computes and its shapes.

Model FLOPs count the products a dense implementation needs: 2 m k n for
each matrix product and convolution tap, 4 s l d per head for attention
(QK^T and PV). Norms, softmax and pointwise work are left out. Both CFG
branches count in full whatever the program shares between them; a PAB
reuse step leaves out the attention sites it reads from the cache.
"""

from __future__ import annotations

from collections import defaultdict

# dense bf16 tensor-core peak (TFLOP/s) and memory rate (TB/s) by card, from
# NVIDIA's data sheets, matched against torch.cuda.get_device_name() in order
CARD_PEAKS = (
    ("H100 PCIe", 756.0, 2.0),
    ("H100 NVL", 835.0, 3.9),
    ("H200", 989.0, 4.8),
    ("H100", 989.0, 3.35),  # SXM5 (HBM3)
)


def card_peaks(name: str) -> tuple:
    """(FLOP/s, bytes/s) of the card named `name`."""
    for key, tflops, tbs in CARD_PEAKS:
        if key in name:
            return tflops * 1e12, tbs * 1e12
    raise RuntimeError(f"no published peaks recorded for {name!r}")


class Counter:
    def __init__(self):
        self.by = defaultdict(float)

    def mm(self, cls, m, k, n, batch=1):
        self.by[cls] += 2.0 * batch * m * k * n

    def attn(self, cls, sq, sk, width, batch):
        self.by[cls] += 4.0 * batch * sq * sk * width

    @property
    def total(self):
        return sum(self.by.values())


def unet_eval(u: dict, rows: int, frames: int, lh: int, lw: int, ctx_len: int,
              skip_kinds=()) -> Counter:
    """One UNet call on `rows` latents of `frames` frames at lh x lw.
    `skip_kinds`: the cache-site families ("spatial", "cross", "temporal",
    "ff") read from the cache instead of computed (a PAB reuse step)."""
    c = Counter()
    mc, nhc, depth = u["model_channels"], u["num_head_channels"], u["transformer_depth"]
    tl, cd = u["text_context_len"], u["context_dim"]
    ted = 4 * mc
    bt = rows * frames
    img_len = ctx_len - tl if u["image_cross_attention"] else 0

    def hw(ds):
        return (lh // ds) * (lw // ds)

    def conv(s, cin, cout, k=3):
        c.mm("conv", s, k * k * cin, cout, batch=bt)

    def ff(n, dim):
        if "ff" not in skip_kinds:
            c.mm("ff", n, dim, 8 * dim)
            c.mm("ff", n, 4 * dim, dim)

    def spatial(ch, s):
        c.mm("proj", s, ch, ch, batch=2 * bt)  # proj_in, proj_out
        for _ in range(depth):
            if "spatial" not in skip_kinds:
                c.mm("spatial_attn", s, ch, 4 * ch, batch=bt)  # q, k, v, out
                c.attn("spatial_attn", s, s, ch, bt)
            if "cross" not in skip_kinds:
                c.mm("cross_attn", s, ch, 2 * ch, batch=bt)  # q, out
                c.mm("cross_attn", tl, cd, 2 * ch, batch=bt)
                if img_len:
                    c.mm("cross_attn", img_len, cd, 2 * ch, batch=bt)
                c.attn("cross_attn", s, tl + img_len, ch, bt)
            ff(bt * s, ch)

    def temporal(ch, s, heads=None):
        inner = heads * nhc if heads else ch
        n = bt * s
        c.mm("proj", n, ch, inner)
        c.mm("proj", n, inner, ch)
        for _ in range(depth):
            if "temporal" not in skip_kinds:
                for _ in range(2):
                    c.mm("temporal_attn", n, inner, 4 * inner)
                    c.attn("temporal_attn", frames, frames, inner, rows * s)
            ff(n, inner)

    def res(cin, cout, s):
        conv(s, cin, cout)
        c.mm("proj", 1, ted, cout, batch=bt)
        conv(s, cout, cout)
        if cin != cout:
            conv(s, cin, cout, k=1)
        if u["temporal_conv"]:
            for _ in range(4):
                c.mm("temporal_conv", bt * s, 3 * cout, cout)

    c.mm("proj", rows, mc, ted)
    c.mm("proj", rows, ted, ted)
    if u["fs_condition"]:
        c.mm("proj", rows, mc, ted)
        c.mm("proj", rows, ted, ted)
    conv(hw(1), u["in_channels"], mc)
    if u["addition_attention"]:
        temporal(mc, hw(1), heads=8)
    chans, ch, ds = [mc], mc, 1
    mult = u["channel_mult"]
    for level, m in enumerate(mult):
        for _ in range(u["num_res_blocks"]):
            res(ch, m * mc, hw(ds))
            ch = m * mc
            if ds in u["attention_resolutions"]:
                spatial(ch, hw(ds))
                if u["temporal_attention"]:
                    temporal(ch, hw(ds))
            chans.append(ch)
        if level != len(mult) - 1:
            conv(hw(ds * 2), ch, ch)
            chans.append(ch)
            ds *= 2
    res(ch, ch, hw(ds))
    spatial(ch, hw(ds))
    if u["temporal_attention"]:
        temporal(ch, hw(ds))
    res(ch, ch, hw(ds))
    for level, m in list(enumerate(mult))[::-1]:
        for j in range(u["num_res_blocks"] + 1):
            res(ch + chans.pop(), m * mc, hw(ds))
            ch = m * mc
            if ds in u["attention_resolutions"]:
                spatial(ch, hw(ds))
                if u["temporal_attention"]:
                    temporal(ch, hw(ds))
            if level and j == u["num_res_blocks"]:
                ds //= 2
                conv(hw(ds), ch, ch)
    conv(hw(1), mc, u["out_channels"])
    return c


def vae(v: dict, height: int, width: int, direction: str) -> Counter:
    """One frame through the KL-VAE's encoder or decoder."""
    c = Counter()
    ch, mult, nres, z = v["ch"], v["ch_mult"], v["num_res_blocks"], v["z_channels"]

    def conv(s, cin, cout, k=3):
        c.mm("vae", s, k * k * cin, cout)

    def res(cin, cout, s):
        conv(s, cin, cout)
        conv(s, cout, cout)
        if cin != cout:
            conv(s, cin, cout, k=1)

    def attn(cin, s):
        for _ in range(4):
            conv(s, cin, cin, k=1)
        c.attn("vae", s, s, cin, 1)

    f = 2 ** (len(mult) - 1)
    if direction == "decoder":
        s = (height // f) * (width // f)
        cin = ch * mult[-1]
        conv(s, v["embed_dim"], z, k=1)  # post_quant_conv
        conv(s, z, cin)
        res(cin, cin, s)
        attn(cin, s)
        res(cin, cin, s)
        for i in reversed(range(len(mult))):
            for _ in range(nres + 1):
                res(cin, ch * mult[i], s)
                cin = ch * mult[i]
            if i:
                s *= 4
                conv(s, cin, cin)
        conv(s, cin, 3)
    else:
        s = height * width
        conv(s, 3, ch)
        cin = ch
        for i, m in enumerate(mult):
            for _ in range(nres):
                res(cin, ch * m, s)
                cin = ch * m
            if i != len(mult) - 1:
                s //= 4
                conv(s, cin, cin)
        res(cin, cin, s)
        attn(cin, s)
        res(cin, cin, s)
        conv(s, cin, 2 * z)
        conv(s, 2 * z, 2 * v["embed_dim"], k=1)  # quant_conv
    return c


def clip_tower(width: int, layers: int, tokens: int) -> float:
    per = 2.0 * tokens * width * (3 * width + width + 8 * width) + 4.0 * tokens * tokens * width
    return layers * per


def conditioning(cfg: dict) -> float:
    """Text towers for the two prompts, vision tower and resampler for the
    condition frame and the zero image."""
    t, vis, r = cfg["clip_text"], cfg["clip_vision"], cfg["resampler"]
    text = 2 * clip_tower(t["width"], t["layers"] - (1 if t["penultimate"] else 0),
                          t["context_length"])
    grid = vis["image_size"] // vis["patch_size"]
    tokens = grid * grid + 1
    vision = clip_tower(vis["width"], vis["layers"], tokens)
    vision += 2.0 * grid * grid * 3 * vis["patch_size"] ** 2 * vis["width"]
    nq = r["num_queries"] * (r["video_length"] or 1)
    inner = r["heads"] * r["dim_head"]
    res = 2.0 * tokens * r["embedding_dim"] * r["dim"] + 2.0 * nq * r["dim"] * r["output_dim"]
    for _ in range(r["depth"]):
        res += 2.0 * nq * r["dim"] * inner + 2.0 * (tokens + nq) * r["dim"] * 2 * inner
        res += 4.0 * nq * (tokens + nq) * inner + 2.0 * nq * inner * r["dim"]
        res += 2.0 * 2 * nq * r["dim"] * r["dim"] * r["ff_mult"]
    return text + 2 * (vision + res)


def context_len(cfg: dict) -> int:
    r = cfg["resampler"]
    return cfg["unet"]["text_context_len"] + r["num_queries"] * (r["video_length"] or 1)


def video(cfg: dict, steps: int, branches: int, reuse_steps: int = 0,
          reuse_kinds=()) -> float:
    """Model FLOPs of one video: conditioning, VAE encode of every guidance
    frame, `steps` UNet calls on the `branches` CFG rows (of which
    `reuse_steps` skip the `reuse_kinds` sites), VAE decode of every frame."""
    f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    lh, lw, t = cfg["height"] // f, cfg["width"] // f, cfg["video_length"]
    ctx = context_len(cfg)
    full = unet_eval(cfg["unet"], branches, t, lh, lw, ctx).total
    reuse = unet_eval(cfg["unet"], branches, t, lh, lw, ctx, reuse_kinds).total
    per_frame = (vae(cfg["vae"], cfg["height"], cfg["width"], "encoder").total
                 + vae(cfg["vae"], cfg["height"], cfg["width"], "decoder").total)
    return (conditioning(cfg) + t * per_frame + (steps - reuse_steps) * full
            + reuse_steps * reuse)


# --------------------------------------------------------------------------
# the hand-written kernels: operations and bytes of one call, from the key
# under which the program counts the call's shapes
# --------------------------------------------------------------------------

BF16 = 2


def kernel_cost(kernel: str, key) -> tuple:
    """(operations, bytes) that one call needs: each input read once and
    each output written once, in the types the call takes."""
    if kernel == "fullkv_attention":
        b, s, sk, h, d = key
        return 4.0 * b * h * s * sk * d, BF16 * b * h * d * (2 * s + 2 * sk)
    if kernel == "fused_ff_layer":
        n, c, inner, c_out = key
        ops = 2.0 * n * c * 2 * inner + 2.0 * n * inner * c_out
        return ops, BF16 * (n * c + n * c_out + 2 * inner * c + inner * c_out)
    if kernel == "temporal_conv3":
        b, t, s, cin, cout = key
        return 2.0 * b * t * s * 3 * cin * cout, BF16 * (b * t * s * (cin + cout) + 3 * cin * cout)
    if kernel == "fused_temporal_layer":
        b, t, s, c, h, d = key
        inner = h * d
        ops = 2.0 * b * t * s * c * 4 * inner + 4.0 * b * s * h * t * t * d
        return ops, BF16 * (2 * b * t * s * c + 4 * inner * c)
    if kernel == "temporal_attention_fused":
        b, t, s, h, d = key
        return 4.0 * b * s * h * t * t * d, BF16 * 4 * b * t * s * h * d
    if kernel == "dual_cross_attention":
        b, s, h, d, lt, li = key
        return 4.0 * b * h * s * (lt + li) * d, BF16 * b * h * d * (2 * s + 2 * (lt + li))
    if kernel == "group_norm_fused":
        n, s, c, _groups, itemsize, _silu = key
        return 0.0, 2.0 * n * s * c * itemsize
    if kernel == "fused_spatial_layer":
        b, s, h, d = key[:4]
        c = h * d
        ops = 2.0 * b * s * c * 4 * c + 4.0 * b * h * s * s * d
        return ops, BF16 * (2 * b * s * c + 4 * c * c)
    raise KeyError(f"no operation count for kernel {kernel!r}")
