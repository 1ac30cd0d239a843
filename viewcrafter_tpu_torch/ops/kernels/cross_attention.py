"""Dual-stream cross-attention (text keys and image keys, one softmax per
stream, outputs added): hand-written CUDA kernel + plain twin.

Replaces the TPU kernel
`viewcrafter_tpu/ops/pallas/cross_attention.py:dual_cross_attention`.

Semantics kept from the TPU kernel: f32 logits of the bf16 q and k, scaled by
d^-1/2 after the product; for each stream its own max, exp, sum and division
in f32; the *normalised* probabilities of both streams rounded to bf16 and
multiplied with [v_text ; v_img] in one f32 accumulation; output rounded to
bf16.

Kernel (`csrc/cross_attention.cu`), for Hopper: a block of two warpgroups
walks 128-row query tiles of one (batch, head), 64 rows each; K and V of
both streams come into shared memory once by TMA, and each warpgroup keeps a
ring of its query rows in flight (TMA + mbarriers). On the flagship's shapes
(D = 64, 65-80 text keys, 193-256 image keys) each stream's logits fit one
wgmma accumulator whole (m64n80, m64n256): one pass per stream, max, one
exp2 per logit, sum and its reciprocal, the *normalised* P rounded to bf16
in registers (the TPU kernel's rounding point) and fed as the register A
operand of O += P V, both streams into one O; the text softmax runs under
the image Q K^T and the image softmax under the text P V. Other shapes take
each stream in 64-key chunks, in one pass up to 256 keys (128 at D = 128),
in two passes (max and sum, then P V) beyond.

Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s) at the flagship ds1 site
q (50, 9216, 5, 64), Lt = 77, Li = 256: 4 * 50 * 5 * 9216 * 333 * 64 =
0.196 TFLOP ~= 0.20 ms against 0.60 GB of traffic ~= 0.18 ms: bound by
operations, barely.
"""

from __future__ import annotations

import sys

import torch

from viewcrafter_tpu_torch.ops.kernels import _lib

launches = 0  # wrapper calls that launched the CUDA kernel
sites: dict = {}  # (B, Sq, H, D, Lt, Li) -> launches at that shape
backward_plain = 0  # backward passes through the plain twin's VJP
backward_sites: dict = {}  # launch site -> backward passes of launches there
PLAIN_LOGIT_BYTES = 1 << 31  # the plain twin's f32 logits per batch chunk
BLOCK_Q = 128  # query rows per tile of the kernel
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
TARGET_BLOCKS = 528


def dual_cross_attention_plain(q, k_text, v_text, k_img, v_img):
    """The kernel's arithmetic in plain torch, batch-chunked so that the f32
    logits of one chunk stay under PLAIN_LOGIT_BYTES."""
    b, s, h, d = q.shape
    dt = q.dtype
    chunk = plain_chunk(q.shape, k_text.shape[1] + k_img.shape[1])
    outs = []
    for i in range(0, b, chunk):
        sl = slice(i, i + chunk)
        qf = q[sl].float()
        probs = []
        for k in (k_text, k_img):
            logits = torch.einsum("bqhd,bkhd->bhqk", qf, k[sl].float()) * (d ** -0.5)
            e = torch.exp(logits - logits.amax(-1, keepdim=True))
            probs.append(e / e.sum(-1, keepdim=True))
        p = torch.cat(probs, dim=-1).to(dt).float()
        vc = torch.cat([v_text[sl], v_img[sl]], dim=1).float()
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, vc).to(dt))
    return torch.cat(outs, dim=0)


def plain_chunk(q_shape, lkv: int) -> int:
    """Batch rows per chunk of the plain twin (and of its VJP)."""
    _, s, h, _ = q_shape
    return max(1, PLAIN_LOGIT_BYTES // (h * s * lkv * 4))


def _smem_bytes(lt: int, li: int, d: int) -> int:
    lp = -(-(lt + li) // 16) * 16
    return (BLOCK_Q + 2 * lp) * (d + 8) * 2


def dual_cross_attention(q, k_text, v_text, k_img, v_img) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v_text: (B, Lt, H, D); k/v_img: (B, Li, H, D).
    Returns attention(q, text) + attention(q, img), each with its own
    softmax, as (B, Sq, H, D). A CPU tensor takes the plain twin; a CUDA
    tensor launches the kernel or raises. Under grad the backward is the
    twin's VJP, one batch chunk of the twin at a time."""
    if not q.is_cuda:
        return dual_cross_attention_plain(q, k_text, v_text, k_img, v_img)
    spec = _lib.KernelSpec(_launch, dual_cross_attention_plain, sys.modules[__name__],
                           plain_chunk(q.shape, k_text.shape[1] + k_img.shape[1]))
    return _lib.launch(spec, q, k_text, v_text, k_img, v_img)


def _launch(q, k_text, v_text, k_img, v_img):
    global launches
    b, s, h, d = q.shape
    lt, li = k_text.shape[1], k_img.shape[1]
    bf = torch.bfloat16
    _lib.require(q, "q", bf)
    _lib.require(k_text, "k_text", bf, (b, lt, h, d))
    _lib.require(v_text, "v_text", bf, (b, lt, h, d))
    _lib.require(k_img, "k_img", bf, (b, li, h, d))
    _lib.require(v_img, "v_img", bf, (b, li, h, d))
    if d not in (64, 128) or lt < 1 or li < 1 or lt + li > 512:
        raise ValueError(f"dual_cross_attention supports head dim 64/128, Lt, Li >= 1 and "
                         f"Lt + Li <= 512, got D={d}, Lt={lt}, Li={li}")
    if _smem_bytes(lt, li, d) > SMEM_LIMIT:
        raise ValueError(f"dual_cross_attention: {lt + li} keys of head dim {d} do not fit "
                         f"a block's shared memory")
    tiles = -(-s // BLOCK_Q)
    q_chunks = max(1, min(tiles, -(-TARGET_BLOCKS // (b * h))))
    tiles_per_block = -(-tiles // q_chunks)
    out = torch.empty_like(q)
    err = _lib.lib().vc_dual_cross_attention(
        q.data_ptr(), k_text.data_ptr(), v_text.data_ptr(), k_img.data_ptr(), v_img.data_ptr(),
        out.data_ptr(), b, s, lt, li, h, d, tiles_per_block, d ** -0.5, _lib.stream_ptr())
    _lib.check(err, "dual_cross_attention")
    launches += 1
    key = (b, s, h, d, lt, li)
    sites[key] = sites.get(key, 0) + 1
    return out


# -- the TPU package's gate, copied so the same sites take the kernel ------


def _pick_sb(s: int) -> int:
    for b in (1024, 512, 384, 256, 192, 128):
        if s % b == 0:
            return b
    return 0


def supports_dual(q_shape, lt: int, li: int) -> bool:
    """Mirror of `cross_attention.supports_dual` of the JAX package, and the
    keys must fit a block's shared memory (at head dim 128 that stops at
    Lt + Li = 352; head dim 64 takes all 512)."""
    _, s, _, d = q_shape
    return (li > 0 and lt + li <= 512 and d in (64, 128) and _pick_sb(s) > 0
            and _smem_bytes(lt, li, d) <= SMEM_LIMIT)
