"""The hybrid LM cell's starting parameters, drawn on the device from the
seed by the benchmark itself: nothing of the program under test draws or
lays them out.

The layout is the one ``reference/kimi_linear.py`` documents, from the
configuration's own lists (``linear_attn_config``'s 1-based
``kda_layers``; the rest latent attention): the first
``first_k_dense_replace`` layers unrolled as ``stack.prefix_i``; of the
rest, the shortest run of layer kinds that repeats from their start and
covers the most of them at least twice, looped, its leaves stacked on a
leading axis over the blocks under ``stack.blocks.p<j>``; what is left
after it unrolled as ``stack.suffix_i``. The draws are
``harness/lm_inputs.py``'s (each matrix normal with standard deviation
(the width it contracts over)^-1/2, a short convolution's over its width,
the embedding standard normal, norms 1, the selection bias from the
configuration's own seed), and each KDA layer's ``a_log`` (A = exp(A_log)
uniform in [1, 16]) and ``dt_bias`` (softplus(dt_bias) log-uniform in
[1e-3, 0.1]). Each leaf has a generator of its own, stream
``lm_inputs.FIRST_STREAM`` plus its place in sorted order, so that one
leaf can be drawn again alone.
"""

from __future__ import annotations

import math

import torch

from harness import inputs, lm_inputs

ONES, EMBED, BIAS = lm_inputs.ONES, lm_inputs.EMBED, lm_inputs.BIAS
A_LOG, DT_BIAS = "a_log", "dt_bias"


def layer_kinds(conf: dict) -> list:
    """(KDA?, dense FFN?) of each layer in order."""
    kda = set(conf["linear_attn_config"]["kda_layers"])
    return [(i in kda, i <= conf["first_k_dense_replace"])
            for i in range(1, conf["num_hidden_layers"] + 1)]


def layout(conf: dict):
    """(prefix kinds, the looped run, its repeats, suffix kinds)."""
    kinds = layer_kinds(conf)
    k = conf["first_k_dense_replace"]
    pre, body = kinds[:k], kinds[k:]
    run, cover = body, 0
    for p in range(1, len(body) // 2 + 1):
        n = 1
        while body[n * p:(n + 1) * p] == body[:p]:
            n += 1
        if n >= 2 and n * p > cover:
            run, cover = body[:p], n * p
    n = cover // len(run) if cover else 0
    if n <= 1:
        return kinds, [], 0, []
    return pre, run, n, body[n * len(run):]


def shapes(conf: dict) -> dict:
    """Each leaf of the reference config ``conf`` (the configuration
    file's keys, ``router_width`` and ``kda_gate_rank``), in sorted order:
    (shape, how it is drawn), the latter the width the matrix contracts
    over, ``EMBED``, ``ONES``, ``BIAS``, ``A_LOG`` or ``DT_BIAS``."""
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    n, r = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
    v, L = conf["v_head_dim"], conf["kv_lora_rank"]
    E, held = conf["router_width"], conf["n_routed_experts"]
    F, Fd = conf["moe_intermediate_size"], conf["intermediate_size"]
    Fs = conf["num_shared_experts"] * F
    lac = conf["linear_attn_config"]
    Hk, d, K = lac["num_heads"], lac["head_dim"], lac["short_conv_kernel_size"]
    P, rk = Hk * d, conf["kda_gate_rank"]

    def layer(name: str, lead: tuple, kind) -> dict:
        is_kda, dense = kind
        out = {"norm.w": ((D,), ONES), "norm2.w": ((D,), ONES)}
        if is_kda:
            out.update({"mixer.w_qkv": ((D, 3, P), D),
                        "mixer.conv_w": ((K, 3 * P), K),
                        "mixer.w_fa": ((D, rk), D),
                        "mixer.w_fb": ((rk, P), rk),
                        "mixer.dt_bias": ((P,), DT_BIAS),
                        "mixer.a_log": ((Hk,), A_LOG),
                        "mixer.w_b": ((D, Hk), D),
                        "mixer.w_ga": ((D, rk), D),
                        "mixer.w_gb": ((rk, P), rk),
                        "mixer.o_norm.w": ((d,), ONES),
                        "mixer.wo": ((P, D), P)})
        else:
            out.update({"attn.wq": ((D, H * (n + r)), D),
                        "attn.wkva": ((D, L + r), D),
                        "attn.kv_norm.w": ((L,), ONES),
                        "attn.wkvb": ((L, H * (n + v)), L),
                        "attn.wo": ((H * v, D), H * v)})
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
    pre, run, reps, post = layout(conf)
    for i, kind in enumerate(pre):
        out.update(layer(f"stack.prefix_{i}", (), kind))
    for j, kind in enumerate(run if reps else []):
        out.update(layer(f"stack.blocks.p{j}", (reps,), kind))
    for i, kind in enumerate(post):
        out.update(layer(f"stack.suffix_{i}", (), kind))
    return dict(sorted(out.items()))


def params(conf: dict, seed: int, device, keys=None) -> dict:
    """The starting leaves of ``conf`` (all, or those named in ``keys``)
    from ``seed``, float32 on ``device``, by dotted name."""
    out = {}
    for i, (name, (shape, how)) in enumerate(shapes(conf).items()):
        if keys is not None and name not in keys:
            continue
        gen = inputs.generator(seed, lm_inputs.FIRST_STREAM + i, device)
        if how == ONES:
            leaf = torch.ones(shape, device=device)
        elif how == BIAS:
            b = conf["assumed"]["selection_bias"]
            fixed = torch.Generator().manual_seed(b["seed"])
            leaf = (b["std"] * torch.randn(shape, generator=fixed)).to(device)
        elif how == A_LOG:
            leaf = torch.log(1 + 15 * torch.rand(shape, device=device,
                                                 generator=gen))
        elif how == DT_BIAS:
            lo, hi = math.log(1e-3), math.log(0.1)
            dt = torch.exp(lo + (hi - lo) * torch.rand(
                shape, device=device, generator=gen))
            leaf = dt + torch.log(-torch.expm1(-dt))     # softplus⁻¹(dt)
        else:
            leaf = torch.randn(shape, device=device, generator=gen)
            if how != EMBED:
                leaf.mul_(how ** -0.5)
        out[name] = leaf
    return out
