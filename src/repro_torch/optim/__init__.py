from repro_torch.optim.adamw import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_grads,
    cosine_lr,
    global_norm,
    opt_state_schema,
    quantize_int8,
)

__all__ = [
    "adamw_init", "adamw_update", "clip_by_global_norm", "compress_grads",
    "cosine_lr", "global_norm", "opt_state_schema",
    "quantize_int8",
]
