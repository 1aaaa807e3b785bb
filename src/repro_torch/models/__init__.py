from . import encdec, mlp, resnet
from .common import (LayerKind, ModelConfig, ParamSpec, active_params, init_params, num_params,
                     tree_leaves, tree_map)
from .registry import ModelDef, PagedDef, get_model

__all__ = [
    "LayerKind",
    "ModelConfig",
    "ModelDef",
    "PagedDef",
    "ParamSpec",
    "active_params",
    "encdec",
    "get_model",
    "init_params",
    "mlp",
    "num_params",
    "resnet",
    "tree_leaves",
    "tree_map",
]
