from .em import Trainer, TrainerConfig  # noqa: F401
