"""Seconds from the process's start to the window's start: imports, the
kernel library (built at a checkout's first run), the model, the seeded
traffic and the warm-up."""


def read(run):
    return run.setup_s
