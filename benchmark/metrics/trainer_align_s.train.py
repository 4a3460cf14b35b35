"""Seconds an EM iteration spends in the trainer's align phase, from
``Trainer.phase_seconds`` (the program's own host-clock split), averaged
over the window's iterations."""


def read(run):
    phases = run.work.get("phase_seconds")
    if not phases:
        return None
    return sum(p["align"] for p in phases) / len(phases)
