from repro_torch.common.schema import ParamDef, init_params

__all__ = ["ParamDef", "init_params"]
