"""Peak device memory of the window: torch.cuda.max_memory_allocated()
after a reset at the window's start, in GiB."""


def read(w):
    return w.peak_bytes / 2 ** 30 if w.peak_bytes else None
