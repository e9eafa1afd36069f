"""The LM cell's starting parameters, drawn on the device from the seed by
the benchmark itself: nothing of the program under test draws or lays them
out.

The layout is the one ``reference/moonlight.py`` documents: dotted leaf
names; the first ``first_k_dense_replace`` layers unrolled as
``stack.prefix_i``, the MoE layers stacked on a leading axis under
``stack.blocks.p0``. Each matrix is normal with standard deviation (the
width it contracts over)^-1/2, the embedding standard normal, each norm's
scale 1, and each MoE layer's selection bias N(0, std²) from the
configuration's own fixed seed (``assumed.selection_bias``), the same in
every run. Each leaf has a generator of its own, stream ``FIRST_STREAM``
plus its place in sorted order, so that one leaf can be drawn again
alone.
"""

from __future__ import annotations

import torch

from harness import inputs

FIRST_STREAM = 16
ONES, EMBED, BIAS = "ones", "embed", "bias"


def shapes(conf: dict) -> dict:
    """Each leaf of the reference config ``conf`` (the configuration file's
    keys and ``router_width``), in sorted order: (shape, how it is drawn),
    the latter the width the matrix contracts over, ``EMBED``, ``ONES`` or
    ``BIAS``."""
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    n, r = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
    v, L = conf["v_head_dim"], conf["kv_lora_rank"]
    E, held = conf["router_width"], conf["n_routed_experts"]
    F, Fd = conf["moe_intermediate_size"], conf["intermediate_size"]
    Fs = conf["n_shared_experts"] * F
    k = conf["first_k_dense_replace"]
    n_moe = conf["num_hidden_layers"] - k

    def layer(name: str, lead: tuple, dense: bool) -> dict:
        out = {"norm.w": ((D,), ONES), "norm2.w": ((D,), ONES),
               "attn.wq": ((D, H * (n + r)), D),
               "attn.wkva": ((D, L + r), D),
               "attn.kv_norm.w": ((L,), ONES),
               "attn.wkvb": ((L, H * (n + v)), L),
               "attn.wo": ((H * v, D), H * v)}
        if dense:
            out.update({"mlp.w_gateup": ((D, 2, Fd), D),
                        "mlp.w_down": ((Fd, D), Fd)})
        else:
            out.update({"moe.router": ((D, E), D), "moe.bias": ((E,), BIAS),
                        "moe.w_gate": ((held, D, F), D),
                        "moe.w_up": ((held, D, F), D),
                        "moe.w_down": ((held, F, D), F),
                        "moe.shared.w_gateup": ((D, 2, Fs), D),
                        "moe.shared.w_down": ((Fs, D), Fs)})
        return {f"{name}.{key}": (lead + s, how)
                for key, (s, how) in out.items()}

    out = {"embed.table": ((conf["vocab_size"], D), EMBED),
           "unembed.table": ((conf["vocab_size"], D), D),
           "final_norm.w": ((D,), ONES)}
    for i in range(k):
        out.update(layer(f"stack.prefix_{i}", (), True))
    if n_moe:
        out.update(layer("stack.blocks.p0", (n_moe,), False))
    return dict(sorted(out.items()))


def params(conf: dict, seed: int, device, keys=None) -> dict:
    """The starting leaves of ``conf`` (all, or those named in ``keys``)
    from ``seed``, float32 on ``device``, by dotted name."""
    out = {}
    for i, (name, (shape, how)) in enumerate(shapes(conf).items()):
        if keys is not None and name not in keys:
            continue
        if how == ONES:
            leaf = torch.ones(shape, device=device)
        elif how == BIAS:
            b = conf["assumed"]["selection_bias"]
            gen = torch.Generator().manual_seed(b["seed"])
            leaf = (b["std"] * torch.randn(shape, generator=gen)).to(device)
        else:
            leaf = torch.randn(shape, device=device, generator=(
                inputs.generator(seed, FIRST_STREAM + i, device)))
            if how != EMBED:
                leaf.mul_(how ** -0.5)
        out[name] = leaf
    return out
