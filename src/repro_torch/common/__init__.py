from repro_torch.common.config import (LAYER_KINDS, SHAPES, ModelConfig,
                                       ShapeConfig, TrainConfig, reduced)
from repro_torch.common.schema import (ParamDef, count_params, init_params,
                                       stack)

__all__ = ["LAYER_KINDS", "ModelConfig", "ParamDef", "SHAPES", "ShapeConfig",
           "TrainConfig", "count_params", "init_params", "reduced", "stack"]
