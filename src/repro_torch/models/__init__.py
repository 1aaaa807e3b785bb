from . import encdec, mlp, resnet
from .common import (LayerKind, ModelConfig, ParamSpec, abstract_params, active_params,
                     cast_specs, init_params, num_params, param_axes, tree_leaves, tree_map)
from .registry import ModelDef, PagedDef, get_model

__all__ = [
    "LayerKind",
    "ModelConfig",
    "ModelDef",
    "PagedDef",
    "ParamSpec",
    "abstract_params",
    "active_params",
    "cast_specs",
    "encdec",
    "get_model",
    "init_params",
    "mlp",
    "num_params",
    "param_axes",
    "resnet",
    "tree_leaves",
    "tree_map",
]
