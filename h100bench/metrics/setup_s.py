"""Set-up: process start to the first timed request (the program and its
weights built, the kernel library loaded or built, the cell's shapes warmed
up)."""


def read(w):
    return w.setup_s
