from repro_torch.train.loop import train_loop
from repro_torch.train.pipeline import (make_sage_train_step, pipelined_apply,
                                        split_stages, state_from_jax)
from repro_torch.train.step import (batch_logical_specs, batch_structs,
                                    init_state, make_decode_step,
                                    make_prefill_step, make_train_step,
                                    state_logical_specs, state_schema)

__all__ = ["batch_logical_specs", "batch_structs", "init_state",
           "make_decode_step", "make_prefill_step", "make_sage_train_step",
           "make_train_step", "pipelined_apply", "split_stages",
           "state_from_jax", "state_logical_specs", "state_schema",
           "train_loop"]
