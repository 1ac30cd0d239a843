"""Seconds per video: the measured window (first request's start to the
last one's end, on the host's clock) over the requests it served."""


def read(w):
    return w.window_s / w.requests
