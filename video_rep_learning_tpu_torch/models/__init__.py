"""Model factory and modules of the port: CARL (ResNet + late transformer)
and MV-Former (fully frozen ViT or ResNet + the multi-entity head)."""

from .carl import (CARLModel, ModelSpec, build_model, resolve_model_spec,  # noqa: F401
                   set_trainable)
from .weights import load_checkpoint, save_checkpoint, state_dict_from_numpy  # noqa: F401
