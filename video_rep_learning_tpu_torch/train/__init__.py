from .checkpoint import resume, save_checkpoint  # noqa: F401
from .optimizer import Optimizer, learning_rate_for_epoch  # noqa: F401
from .trainer import Trainer  # noqa: F401
