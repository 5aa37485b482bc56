from .loop import StragglerMonitor, Trainer
from .step import init_state, make_train_step

__all__ = ["make_train_step", "init_state", "Trainer", "StragglerMonitor"]
