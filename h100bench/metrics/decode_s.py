"""Diffusion entry: seconds of the VAE decode per request, from the last
sampling step's hook to the `on_stage("decode")` hook, synchronised."""

from h100bench.metrics._stages import durations


def read(w):
    got = [s for name, s in durations(w) if name == "decode"] if w.marks else []
    return sum(got) / len(got) if got else None
