"""Seconds an EM iteration spends in the trainer's estimate phase, from
``Trainer.phase_seconds`` (the program's own host-clock split), averaged
over the window's iterations."""


def read(run):
    phases = run.work.get("phase_seconds")
    if not phases:
        return None
    return sum(p["estimate"] for p in phases) / len(phases)
