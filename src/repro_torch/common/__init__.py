from repro_torch.common.config import (LAYER_KINDS, ModelConfig, TrainConfig,
                                       reduced)
from repro_torch.common.schema import (ParamDef, count_params, init_params,
                                       stack)

__all__ = ["LAYER_KINDS", "ModelConfig", "ParamDef", "TrainConfig",
           "count_params", "init_params", "reduced", "stack"]
