"""LM training on one chip's share of an expert-parallel deployment: each
step is ``repro_torch.train.make_train_step`` — the model's ``loss_fn``
over B sequences of S tokens (causal over each whole sequence, labels the
next tokens), ``torch.autograd.grad``, and ``optim.adamw_update`` with
the traffic's hyperparameters — on the configuration the cell names,
built from its file's published keys and its cut (``program_config``).

Set-up draws the starting parameters on the card from the seed in the
benchmark's own layout (``harness/lm_inputs.py``, the selection bias from
the file's fixed seed), holds their names and shapes to the program's
parameter tree, and hands them to the program; the tokens, uniform over
the vocabulary slice, come from the seed too. The program takes the first
``CHECKED_STEPS`` steps through the window's own step, and more up to
``WARM_STEPS``, so that the window opens on a card at the clocks it holds
under load; the window goes on from there with that state. After the
window the program's state is let go and the plain float32 reference
(``reference/moonlight.py``) follows the checked steps from the same
parameters, drawn again from the seed, so that the two fit on the card
one after the other and set-up times the program alone.

Compared, as the full-batch GraphSAGE cell compares them: each checked
step's total loss (``loss_gap``); the first gradient as the optimizer got
it (its first moment after one step, over 1 − beta1), leaf by leaf
(``grad_gap``); the parameters' change over the checked steps, leaf by
leaf (``change_gap``): each leaf's gap between the two sides' norms over
the reference's norm of that leaf or of the median leaf, whichever is
larger, the worst leaf reported. A leaf whose first reference gradient is
under a thousandth of the median leaf's moves under AdamW by round-off
alone and is left out of the change. The selection bias is a buffer, in
none of them. And the routing itself (``route_gap``): the first MoE
layer's routing weights in the first checked step against the
reference's router on the same input rows, as (tokens × experts) weights,
the largest |difference| over ``routed_scaling_factor``. (Set against
bf16 noise at random weights, the gradients' norms cannot tell weights
taken from s + b from sound ones: the bias moves each weight by a few
percent, and the router's gradient differs between the two sides by a
third of its norm in direction already.) A window step whose loss is
not finite fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys

import torch

from harness import compare, inputs, lm_counts, lm_inputs
from reference import moonlight as reference
from repro_torch.common.config import TrainConfig
from repro_torch.common.schema import frozen_paths, leaves
from repro_torch.common.tree import prune
from repro_torch.configs import moonlight_16b_a3b
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import make_train_step

UNIT = "step"
# the steps of set-up that the reference follows
CHECKED_STEPS = 3
# set-up's steps in all: those past the checked ones bring the card to the
# clocks it holds under the window's load before the window opens
WARM_STEPS = 15
BIAS = "moe.bias"


def program_config(conf: dict):
    """The port's ``ModelConfig`` of the configuration file ``conf``:
    its published keys, the held experts and vocabulary slice of its
    deployment, and what it assumes. Raises where the file asks for a
    mechanism the port does not run as published."""
    want = {"scoring_func": "sigmoid", "topk_method": "noaux_tc",
            "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
            "seq_aux": True, "q_lora_rank": None, "hidden_act": "silu",
            "moe_layer_freq": 1, "attention_bias": False}
    bad = {k: conf[k] for k, v in want.items() if conf[k] != v}
    if bad:
        raise ValueError(f"the port runs no {bad}")
    d = conf["deployment"]
    whole = dataclasses.replace(
        moonlight_16b_a3b.CONFIG,
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        head_dim=conf["qk_nope_head_dim"],
        qk_rope_dim=conf["qk_rope_head_dim"], v_head_dim=conf["v_head_dim"],
        kv_lora_rank=conf["kv_lora_rank"],
        d_ff=conf["moe_intermediate_size"],
        d_ff_dense=conf["intermediate_size"],
        first_k_dense=conf["first_k_dense_replace"],
        n_experts=conf["published"]["n_routed_experts"],
        held_experts=conf["published"]["n_routed_experts"],
        n_shared_experts=conf["n_shared_experts"],
        top_k=conf["num_experts_per_tok"],
        routed_scale=conf["routed_scaling_factor"],
        rope_theta=float(conf["rope_theta"]), norm_eps=conf["rms_norm_eps"],
        tie_embeddings=conf["tie_word_embeddings"],
        router_aux_coef=conf["assumed"]["aux_alpha"],
        **conf["model"])
    cfg = moonlight_16b_a3b.share(whole, ep=d["expert_parallel"],
                                  rank=d["rank"], vocab=conf["vocab_size"])
    if cfg.held_experts != conf["n_routed_experts"]:
        raise ValueError(f"{d['expert_parallel']} chips of "
                         f"{cfg.n_experts} experts hold {cfg.held_experts} "
                         f"each, not {conf['n_routed_experts']}")
    return cfg


def reference_config(conf: dict) -> dict:
    """The reference's plain dict: the file's keys, the router's width,
    the first held expert and the balance loss's alpha."""
    held = conf["n_routed_experts"]
    return {**conf, "router_width": conf["published"]["n_routed_experts"],
            "held_first": conf["deployment"]["rank"] * held,
            "aux_alpha": conf["assumed"]["aux_alpha"]}


def _flat(tree):
    return reference.flat(tree)


class Runner:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.conf = cell.config
        self.hp = dict(cell.traffic["adamw"])
        self.B, self.S = cell.traffic["batch"], cell.traffic["seq_len"]
        self.cfg = program_config(self.conf)
        self.losses, self.window_losses = [], []

    def counts(self) -> dict:
        return {"flops": lm_counts.train_flops(
            reference_config(self.conf), self.B, self.S)}

    def _inputs(self):
        dev, V = self.device, self.cfg.vocab
        ids = torch.randint(0, V, (self.B, self.S + 1), device=dev,
                            generator=inputs.generator(self.seed, 1, dev))
        self.batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
        return lm_inputs.params(reference_config(self.conf), self.seed, dev)

    def _program_params(self, flat: dict) -> dict:
        """``flat`` as the program's parameter tree (the same tensors);
        raises where the program's tree names or shapes its leaves
        otherwise."""
        schema = T.model_schema(self.cfg)
        want = {".".join(p): (tuple(d.shape), d.dtype)
                for p, d in leaves(schema)}
        have = {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}
        if want != have:
            diff = sorted(set(want.items()) ^ set(have.items()))
            raise ValueError(f"the program's parameters differ from the "
                             f"benchmark's layout: {diff[:6]}")
        self.frozen = frozen_paths(schema)
        return reference_tree(flat)

    def _start(self, keys) -> dict:
        """The starting leaves named in ``keys``, drawn again."""
        return lm_inputs.params(reference_config(self.conf), self.seed,
                                self.device, keys)

    def _reference(self) -> None:
        """The reference's checked steps from the starting parameters:
        their losses, first gradient and change."""
        flat = self._start(None)
        keys = sorted(k for k in flat if not k.endswith(BIAS))
        opt = reference.AdamW({k: flat[k] for k in keys}, self.hp)
        rcfg = reference_config(self.conf)
        tree = reference_tree(flat)
        self.ref_losses = []
        for step in range(len(self.losses)):
            for k in keys:
                flat[k].requires_grad_(True)
            total, _, _ = reference.loss(tree, self.batch["tokens"],
                                         self.batch["labels"], rcfg)
            grads = torch.autograd.grad(total, [flat[k] for k in keys])
            for k in keys:
                flat[k].requires_grad_(False)
            opt.step({k: flat[k] for k in keys}, dict(zip(keys, grads)))
            del grads
            self.ref_losses.append(float(total.detach()))
            if step == 0:
                self.ref_grad = first_grad(opt.m, self.hp)
        del opt
        self.ref_change = change(flat, self._start)

    def setup(self):
        params = self._program_params(self._inputs())
        self.tc = TrainConfig(**self.hp)
        self.state = {"params": params,
                      "opt": adamw.adamw_init(prune(params, self.frozen),
                                              self.tc),
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=self.device)}
        self.train_step = make_train_step(self.cfg, self.tc)

    def _step(self) -> torch.Tensor:
        self.state, metrics = self.train_step(self.state, self.batch)
        return metrics["total_loss"]

    def warm(self):
        self.route = None
        for k in range(CHECKED_STEPS):
            with (self._first_route() if k == 0
                  else contextlib.nullcontext()):
                self.losses.append(self._step())
            if k == 0:
                self.first_grad = first_grad(_flat(self.state["opt"]["m"]),
                                             self.hp)
        self.change = change(_flat(self.state["params"]), self._start)
        for _ in range(CHECKED_STEPS, WARM_STEPS):
            self._step()

    @contextlib.contextmanager
    def _first_route(self):
        """Keep the router's inputs and outputs of its first call (the
        first MoE layer's forward) while the block runs."""
        old = moe.sigmoid_route

        def fn(router_w, bias, x, cfg, seq_len):
            out = old(router_w, bias, x, cfg, seq_len)
            if self.route is None:
                self.route = [t.detach().clone() for t in
                              (router_w, bias, x, out[0], out[1])]
            return out
        moe.sigmoid_route = fn
        try:
            yield
        finally:
            moe.sigmoid_route = old

    def _route_gap(self) -> float:
        router_w, bias, x, w, ids = self.route
        rcfg = reference_config(self.conf)
        with torch.no_grad():
            want_w, want_ids, _ = reference.route(
                {"router": router_w.float(), "bias": bias.float()},
                x.float(), rcfg, self.S)
        E = rcfg["router_width"]
        dense = lambda v, i: torch.zeros(  # noqa: E731
            (i.shape[0], E), device=v.device).scatter_(1, i, v.float())
        gap = (dense(w, ids) - dense(want_w, want_ids)).abs().amax()
        return float(gap) / rcfg["routed_scaling_factor"]

    def call(self, i: int):
        self.window_losses.append(self._step())

    def check(self, limits: dict):
        """(the numbers compared, the count of failed answers): a number
        over its limit (each checked step's loss counts apart), or a
        window step whose loss is not finite."""
        del self.state, self.train_step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        matmul = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            self._reference()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn
        gaps = [compare.rel_gap(float(mine), want)
                for mine, want in zip(self.losses, self.ref_losses)]
        moved = {k for k, g in self.ref_grad.items()
                 if g >= 1e-3 * compare.median(self.ref_grad.values())}
        numbers = {
            "loss_gap": max(gaps),
            "grad_gap": compare.leaf_gap(self.first_grad, self.ref_grad),
            "change_gap": compare.leaf_gap(
                {k: self.change[k] for k in moved},
                {k: self.ref_change[k] for k in moved}),
            "route_gap": self._route_gap()}
        failed = sum(not g <= limits["loss_gap"] for g in gaps) + sum(
            not numbers[k] <= limits[k]
            for k in ("grad_gap", "change_gap", "route_gap")
        ) + sum(not math.isfinite(float(x)) for x in self.window_losses)
        return numbers, failed


def reference_tree(flat: dict) -> dict:
    """The nested dict of dotted leaves ``flat`` (the same tensors)."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        *path, last = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def first_grad(m: dict, hp: dict) -> dict:
    """Each leaf's norm of the gradient the optimizer got at its first
    step, from its first moment then: m = (1 − beta1) · g."""
    return {k: float(torch.linalg.vector_norm(v.float())) / (1 - hp["beta1"])
            for k, v in m.items()}


def change(flat: dict, start) -> dict:
    """Each trainable leaf's norm of its change from its start, which
    ``start`` draws for a list of names, one leaf on the card at a
    time."""
    return {k: float(torch.linalg.vector_norm(
        v.detach().float() - start([k])[k]))
        for k, v in flat.items() if not k.endswith(BIAS)}


# ---------------------------------------------------------------------------
# controls: each patches the program under the timed path
# ---------------------------------------------------------------------------

CAPACITY_GROUP, CAPACITY_FACTOR = 512, 1.25


def capacity_drop(old):
    """GShard's capacity rule on top of the router: in each group of 512
    tokens an expert takes int(512 · k · 1.25 / E) + 1 slots in token
    order, and a slot past that gets weight 0 (the rule the capacity path
    of ``moe_apply`` keeps)."""
    def fn(router_w, bias, x, cfg, seq_len):
        w, ids, aux = old(router_w, bias, x, cfg, seq_len)
        E, K = cfg.n_experts, cfg.top_k
        t = min(CAPACITY_GROUP, ids.shape[0])
        C = int(t * K * CAPACITY_FACTOR / E) + 1
        hot = torch.nn.functional.one_hot(ids.reshape(-1, t * K), E)
        pos = (torch.cumsum(hot, dim=1) - hot).mul_(hot).sum(-1)
        keep = (pos < C).reshape(ids.shape)
        fn.dropped.append(int((~keep).sum()))
        if len(fn.dropped) <= 2:
            print(f"capacity control: {fn.dropped[-1]} of {keep.numel()} "
                  f"slots dropped (capacity {C} a group of {t})",
                  file=sys.stderr)
        return w * keep, ids, aux
    fn.dropped = []
    return fn


def biased_weights(old):
    """The routing weights taken from s + b, the selection scores."""
    def fn(router_w, bias, x, cfg, seq_len):
        _, ids, aux = old(router_w, bias, x, cfg, seq_len)
        s = torch.sigmoid(x.float() @ router_w.float()) + bias.float()
        g = torch.gather(s, 1, ids)
        return g / g.sum(-1, keepdim=True) * cfg.routed_scale, ids, aux
    return fn


def _e4m3(t: torch.Tensor, rows=None) -> torch.Tensor:
    """t's values rounded to float8 e4m3 under one scale for the tensor
    (the largest |value| of its ``rows``, all by default, to e4m3's
    largest, 448), in t's dtype; the gradient passes straight through the
    rounding."""
    with torch.no_grad():
        seen = t if rows is None else torch.where(rows, t, 0)
        scale = seen.abs().amax().float().clamp(min=1e-12) / 448.0
        r = ((t.float() / scale).to(torch.float8_e4m3fn).float()
             * scale).to(t.dtype)
    return t + (r - t).detach()


def fp8_inputs(old):
    """Each expert GEMM's inputs rounded to fp8 e4m3 (below the bf16 the
    configuration states); the rows' scale is taken over the rows the
    GEMM computes."""
    def fn(x, w, offs):
        rows = torch.arange(x.shape[0], device=x.device)[:, None] < offs[-1]
        return old(_e4m3(x, rows), _e4m3(w), offs)
    return fn


FAULTS = {"capacity": (moe, "sigmoid_route", capacity_drop),
          "biased": (moe, "sigmoid_route", biased_weights),
          "fp8": (moe, "expert_mm", fp8_inputs)}
