"""Seconds of training audio per second: the corpus's audio times the EM
iterations completed in the window, over the seconds they took, end to end on
the host's clock."""


def read(run):
    seconds = sum(s["seconds"] for s in run.steps)
    return sum(s["audio_s"] for s in run.steps) / seconds if seconds > 0 else None
