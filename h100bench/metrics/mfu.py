"""Whole video: model FLOPs of the window's requests (a walk of the
published architecture, `h100bench/flops.py`) over the window's wall time,
as a share of the card's dense bf16 peak, in %."""


def read(w):
    if not w.peaks or not w.model_flops:
        return None
    return 100.0 * w.model_flops / w.window_s / w.peaks[0]
