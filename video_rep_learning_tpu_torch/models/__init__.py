"""Model factory and modules of the port (the ResNet + late-transformer CARL
family so far)."""

from .carl import (CARLModel, ModelSpec, build_model, resolve_model_spec,  # noqa: F401
                   set_trainable)
from .weights import load_checkpoint, save_checkpoint, state_dict_from_numpy  # noqa: F401
