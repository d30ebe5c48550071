from .trainer import Trainer, TrainerConfig  # noqa: F401
