"""Read an 8-bit, non-interlaced RGB or RGBA PNG with the standard library
and NumPy (the card's machine has no image library to count on)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:  # Up
            cur = (line + prev) & 255
        else:  # Average or Paeth: each byte waits for its left neighbour
            cur = bytearray(stride)
            lb, pb = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = pb[x]
                if ftype == 3:
                    cur[x] = (lb[x] + ((a + b) >> 1)) & 255
                else:
                    c = pb[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pbb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pbb and pa <= pc else (b if pbb <= pc else c)
                    cur[x] = (lb[x] + pred) & 255
            cur = np.frombuffer(bytes(cur), np.uint8).astype(np.int32)
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    width, height, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced RGB or RGBA PNGs are read")
    bpp = 3 if color == 2 else 4
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    return px.reshape(height, width, bpp)[..., :3]
