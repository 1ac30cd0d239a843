"""Sampler (host): milliseconds the host spends in each DDIM step, the mean
of the program's `step` spans (`sampling/ddim.py`; the step's launches, its
denoiser call and update, up to its `on_stage` hook), recorded in a traced
run. Beside `step_ms` (the step's time with the device's work): the
nearer the two, the more the step waits on its launches."""


def read(w):
    steps = [s for s in getattr(w, "spans", None) or () if s.name == "step"]
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in steps) / len(steps) / 1e6
