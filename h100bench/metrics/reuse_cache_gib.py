"""Attention-reuse cache: the largest `reuse_cache_bytes` the program
counted in the traced window (the bytes of the attention cache each full
step of the reuse sampler returned, `sampling/ddim.py`), in GiB. None in a
cell without attention reuse."""


def read(w):
    got = (getattr(w, "counters", None) or {}).get("reuse_cache_bytes")
    return max(got) / 2 ** 30 if got else None
