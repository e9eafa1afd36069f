"""Hybrid LM training (Kimi Linear: Kimi Delta Attention beside latent
attention, MoE FFNs) on one chip's share of an expert-parallel
deployment: each step is ``repro_torch.train.make_train_step`` — the
model's ``loss_fn`` over B sequences of S tokens (causal over each whole
sequence, labels the next tokens), ``torch.autograd.grad``, and
``optim.adamw_update`` with the traffic's hyperparameters — on the
configuration the cell names, built from its file's published keys and
its cut (``program_config``).

Everything else is ``lm_train.py``'s, which this entry runs with its own
pieces: the starting parameters drawn on the card from the seed in the
layout ``reference/kimi_linear.py`` documents (``harness/kda_inputs.py``),
held against the program's tree; ``CHECKED_STEPS`` steps followed by the
plain float32 reference (``reference/kimi_linear.py``) after the window,
from the same parameters drawn again; and the same numbers compared
(``loss_gap``, ``grad_gap``, ``change_gap``, ``route_gap``). It adds
three, each from the first checked step, the largest |difference| over
the reference's largest |value|:

* ``kda_gap``: the first KDA layer's mixer output (the model's first
  layer) against the reference's KDA of the same input rows and
  parameters;
* ``scan_gap``: that layer's scan output against the reference's scan of
  the program's own q, k, v, g and β. The mixer's bf16 projections put
  ~7e-3 into ``kda_gap``; the scan alone compares float32 with float32,
  so a state carried in a lower precision shows here;
* ``expert_gap``: the first MoE layer's output (its held experts' part
  and the shared expert) against the reference's MoE of the same rows
  and parameters. With 512 slots per held expert a layer, an expert GEMM
  in a lower precision moves the parameters' change no more than seeds
  do; it moves the layer's output.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import torch

from harness import faults, inputs, kda_counts, kda_inputs, spec
from reference import kimi_linear as reference
from repro_torch.configs import kimi_linear_48b_a3b as kimi
from repro_torch.models import kda, moe

lm_train = spec.load_module(Path(__file__).with_name("lm_train.py"),
                            "perfbench_entry_lm_train")

UNIT = lm_train.UNIT
CHECKED_STEPS, WARM_STEPS = lm_train.CHECKED_STEPS, lm_train.WARM_STEPS
BIAS = lm_train.BIAS


def program_config(conf: dict):
    """The port's ``ModelConfig`` of the configuration file ``conf``:
    its published keys, the held experts and vocabulary slice of its
    deployment, and what it assumes. Raises where the file asks for a
    mechanism the port does not run as published."""
    want = {"moe_router_activation_func": "sigmoid", "moe_renormalize": True,
            "use_grouped_topk": True, "num_expert_group": 1,
            "topk_group": 1, "q_lora_rank": None, "hidden_act": "silu",
            "moe_layer_freq": 1, "mla_use_nope": True,
            "model_type": "kimi_linear"}
    bad = {k: conf[k] for k, v in want.items() if conf[k] != v}
    if bad:
        raise ValueError(f"the port runs no {bad}")
    lac, d = conf["linear_attn_config"], conf["deployment"]
    whole = dataclasses.replace(
        kimi.CONFIG,
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        head_dim=conf["qk_nope_head_dim"],
        qk_rope_dim=conf["qk_rope_head_dim"], v_head_dim=conf["v_head_dim"],
        kv_lora_rank=conf["kv_lora_rank"], mla_nope=conf["mla_use_nope"],
        d_ff=conf["moe_intermediate_size"],
        d_ff_dense=conf["intermediate_size"],
        first_k_dense=conf["first_k_dense_replace"],
        layers=kimi.layer_kinds(lac["kda_layers"], lac["full_attn_layers"],
                                conf["first_k_dense_replace"]),
        kda_heads=lac["num_heads"], kda_head_dim=lac["head_dim"],
        kda_gate_rank=conf["assumed"]["kda_gate_rank"],
        conv_kernel=lac["short_conv_kernel_size"],
        n_experts=conf["published"]["num_experts"],
        held_experts=conf["published"]["num_experts"],
        n_shared_experts=conf["num_shared_experts"],
        top_k=conf["num_experts_per_token"],
        routed_scale=conf["routed_scaling_factor"],
        rope_theta=float(conf["rope_theta"]), norm_eps=conf["rms_norm_eps"],
        tie_embeddings=conf["tie_word_embeddings"],
        router_aux_coef=conf["assumed"]["aux_alpha"],
        **conf["model"])
    cfg = kimi.share(whole, ep=d["expert_parallel"], rank=d["rank"],
                     vocab=conf["vocab_size"])
    if cfg.held_experts != conf["num_experts"]:
        raise ValueError(f"{d['expert_parallel']} chips of "
                         f"{cfg.n_experts} experts hold {cfg.held_experts} "
                         f"each, not {conf['num_experts']}")
    return cfg


def reference_config(conf: dict) -> dict:
    """The reference's plain dict: the file's keys and what
    ``moonlight.py``'s MoE and balance loss read under their names."""
    held = conf["num_experts"]
    return {**conf, "router_width": conf["published"]["num_experts"],
            "n_routed_experts": held,
            "held_first": conf["deployment"]["rank"] * held,
            "num_experts_per_tok": conf["num_experts_per_token"],
            "aux_alpha": conf["assumed"]["aux_alpha"],
            "kda_gate_rank": conf["assumed"]["kda_gate_rank"]}


class Runner(lm_train.Runner):
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.conf = cell.config
        self.rcfg = reference_config(self.conf)
        self.hp = dict(cell.traffic["adamw"])
        self.B, self.S = cell.traffic["batch"], cell.traffic["seq_len"]
        self.cfg = program_config(self.conf)
        self.losses, self.window_losses = [], []
        self.firsts = {}

    def counts(self) -> dict:
        return {"flops": kda_counts.train_flops(self.rcfg, self.B, self.S)}

    def _inputs(self):
        dev, V = self.device, self.cfg.vocab
        ids = torch.randint(0, V, (self.B, self.S + 1), device=dev,
                            generator=inputs.generator(self.seed, 1, dev))
        self.batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
        return kda_inputs.params(self.rcfg, self.seed, dev)

    def _start(self, keys) -> dict:
        return kda_inputs.params(self.rcfg, self.seed, self.device, keys)

    def _keep_first(self, owner, name: str):
        """A context that keeps the arguments and the result of the first
        call of ``owner.name`` under ``name`` in ``self.firsts``."""
        old = getattr(owner, name)

        def fn(*args, **kwargs):
            out = old(*args, **kwargs)
            if name not in self.firsts:
                keep = lambda t: (  # noqa: E731
                    {k: v.detach().clone()
                     for k, v in reference.flat(t).items()}
                    if isinstance(t, dict) else t.detach().clone()
                    if torch.is_tensor(t) else t)
                self.firsts[name] = ([keep(a) for a in args],
                                     keep(out[0] if isinstance(out, tuple)
                                          else out))
            return out
        return faults._patched(owner, name, lambda _: fn)

    @contextlib.contextmanager
    def _first_route(self):
        """The base's router capture, and the first call's arguments and
        result of the KDA mixer (the model's first layer), its scan and
        the MoE layer."""
        with self._keep_first(kda, "kda_apply"), \
                self._keep_first(kda, "chunk_scan"), \
                self._keep_first(moe, "moe_apply"), super()._first_route():
            yield

    def _firsts_gaps(self) -> dict:
        """``kda_gap``, ``scan_gap`` and ``expert_gap`` (the module
        docstring), each inf where the program's answer is not finite."""
        tree = lm_train.reference_tree
        heads = lambda t: t.transpose(1, 2).float()  # noqa: E731
        (p, x, _), mixer = self.firsts["kda_apply"]
        (q, k, v, g, beta, _), scan = self.firsts["chunk_scan"]
        (pm, xm, _), experts = self.firsts["moe_apply"]
        with torch.no_grad():
            want = {
                "kda_gap": (mixer, reference.kda(tree(p), x.float(),
                                                 self.rcfg)),
                "scan_gap": (scan, heads(reference.kda_scan(
                    heads(q), heads(k), heads(v), heads(g),
                    beta.transpose(1, 2).float()))),
                "expert_gap": (experts, reference.moe(
                    tree(pm), xm.float(), self.rcfg)[0])}
        return {name: float((got.float() - ref).abs().amax()
                            / ref.abs().amax())
                if bool(torch.isfinite(got).all()) else float("inf")
                for name, (got, ref) in want.items()}

    def _route_gap(self) -> float:
        router_w, bias, x, w, ids = self.route
        rcfg = self.rcfg
        with torch.no_grad():
            want_w, want_ids, _ = reference.route(
                {"router": router_w.float(), "bias": bias.float()},
                x.float(), rcfg, self.S)
        E = rcfg["router_width"]
        dense = lambda v, i: torch.zeros(  # noqa: E731
            (i.shape[0], E), device=v.device).scatter_(1, i, v.float())
        gap = (dense(w, ids) - dense(want_w, want_ids)).abs().amax()
        return float(gap) / rcfg["routed_scaling_factor"]

    def _reference(self) -> None:
        """The first KDA layer's reference, then the reference's checked
        steps from the starting parameters: their losses, first gradient
        and change."""
        self.first_gaps = self._firsts_gaps()
        self.firsts = {}
        flat = self._start(None)
        keys = sorted(k for k in flat if not k.endswith(BIAS))
        opt = reference.AdamW({k: flat[k] for k in keys}, self.hp)
        tree = lm_train.reference_tree(flat)
        self.ref_losses = []
        for step in range(len(self.losses)):
            for k in keys:
                flat[k].requires_grad_(True)
            total, _, _ = reference.loss(tree, self.batch["tokens"],
                                         self.batch["labels"], self.rcfg)
            grads = torch.autograd.grad(total, [flat[k] for k in keys])
            for k in keys:
                flat[k].requires_grad_(False)
            opt.step({k: flat[k] for k in keys}, dict(zip(keys, grads)))
            del grads
            self.ref_losses.append(float(total.detach()))
            if step == 0:
                self.ref_grad = lm_train.first_grad(opt.m, self.hp)
        del opt
        self.ref_change = lm_train.change(flat, self._start)

    def check(self, limits: dict):
        """``lm_train``'s numbers, ``kda_gap``, ``scan_gap`` and
        ``expert_gap``."""
        numbers, failed = super().check(limits)
        numbers.update(self.first_gaps)
        return numbers, failed + sum(not v <= limits[k]
                                     for k, v in self.first_gaps.items())


# ---------------------------------------------------------------------------
# controls: each patches the program under the timed path
# ---------------------------------------------------------------------------

def bf16_state(old):
    """The carried KDA state held in bf16 between chunks (each update
    computed in float32 from it, then rounded)."""
    def fn(M, N):
        Ms, Ns = M.unbind(1), N.unbind(1)
        s = M.new_zeros(M.shape[0], M.shape[2], N.shape[3]).bfloat16()
        states = [s]
        for j in range(M.shape[1] - 1):
            s = torch.baddbmm(Ns[j], Ms[j], s.float()).bfloat16()
            states.append(s)
        return torch.stack(states, dim=1).float()
    return fn


def head_decay(old):
    """One decay per head, the mean of its channels', in place of one per
    channel."""
    def fn(p, x, cfg):
        g = old(p, x, cfg)
        return g.mean(-1, keepdim=True).expand_as(g)
    return fn


FAULTS = {**lm_train.FAULTS,
          "bf16_state": (kda, "carry", bf16_state),
          "head_decay": (kda, "decay", head_decay)}
