"""Model factory and modules of the port: CARL (ResNet or ViT + late
transformer, or the conv / vanilla embedders of TCC and TCN) and MV-Former
(fully or partially frozen ViT or ResNet + the multi-entity head)."""

from .carl import (CARLModel, ModelSpec, build_model, resolve_model_spec,  # noqa: F401
                   set_trainable)
from .weights import (context_embed_state_dict, load_checkpoint,  # noqa: F401
                      save_checkpoint, state_dict_from_numpy)
