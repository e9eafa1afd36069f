from repro_torch.train.step import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step"]
