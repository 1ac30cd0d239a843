"""Host-clock durations of the stages of each request, from the synchronised
stage marks of a traced run."""


def durations(w):
    """[(stage name, seconds)] for every mark after the first: the time from
    the mark before it."""
    return [(name, t - prev) for (_, prev), (name, t) in zip(w.marks, w.marks[1:])]


def is_step(name: str) -> bool:
    return name.split(" ")[0] in ("step", "full", "reuse")
