from .checkpoint import CheckpointManager, export_predictions
from .loop import Trainer, TrainConfig

__all__ = ["CheckpointManager", "TrainConfig", "Trainer", "export_predictions"]
