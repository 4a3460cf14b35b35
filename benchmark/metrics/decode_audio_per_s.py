"""Seconds of audio decoded per second: the audio of every step (a whole
corpus call or a job) completed in the window over the seconds those steps
took, end to end on the host's clock."""


def read(run):
    seconds = sum(s["seconds"] for s in run.steps)
    return sum(s["audio_s"] for s in run.steps) / seconds if seconds > 0 else None
