from repro_torch.train.loop import train_loop
from repro_torch.train.pipeline import make_sage_train_step, state_from_jax
from repro_torch.train.step import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step", "make_sage_train_step",
           "state_from_jax", "train_loop"]
