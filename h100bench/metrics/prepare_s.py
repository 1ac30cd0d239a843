"""Diffusion entry: seconds of `generate_staged`'s prepare stage per request
(the guidance latents' VAE encode, the CLIP towers, the resampler), from the
request's start to the `on_stage("prepare")` hook, synchronised."""

from h100bench.metrics._stages import durations


def read(w):
    got = [s for name, s in durations(w) if name == "prepare"] if w.marks else []
    return sum(got) / len(got) if got else None
