"""The plain reference against the port's own plain path (``impl="ref"``)
at tiny sizes: the forward, the loss's gradients and AdamW's steps."""

import dataclasses

import pytest
import torch

from harness import inputs
from reference import gcn as reference
from repro_torch.common.config import TrainConfig
from repro_torch.configs.graphic_gcn import PALLAS_CONFIG
from repro_torch.core import gcn
from repro_torch.graph import partition
from repro_torch.graph.structure import COOGraph
from repro_torch.optim import adamw

torch.set_num_threads(1)

MODEL = dict(n_features=20, hidden=16, n_classes=5, n_layers=2)
HP = dict(learning_rate=3e-4, min_lr_ratio=0.1, warmup_steps=2,
          total_steps=10, weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8,
          grad_clip=1.0)


def _case(seed, impl):
    V = 256
    src, dst, w = inputs.rmat(8, 4, 0.57, 0.19, 0.19,
                              inputs.generator(seed, 0, "cpu"), "cpu")
    x = inputs.tables(1, V, MODEL["n_features"], seed, "cpu")
    params = inputs.params(MODEL, seed, "cpu")
    pg = partition.partition_by_src(
        COOGraph(V, src.numpy(), dst.numpy(), w.numpy()), 1)
    edges = tuple(torch.from_numpy(a) for a in
                  (pg.src, pg.dst, pg.weights, pg.mask))
    cfg = dataclasses.replace(PALLAS_CONFIG, impl=impl, **{
        k: MODEL[k] for k in ("n_features", "hidden", "n_classes")})
    return src, dst, w, x, params, edges, cfg


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_forward_matches_the_port(seed, impl):
    src, dst, w, x, params, edges, cfg = _case(seed, impl)
    got = gcn.gcn_forward_full(params, x, *edges, cfg)[0]
    want = reference.forward(params, x[0], src, dst, w, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gradients_and_adamw_match_the_port():
    src, dst, w, x, p0, edges, cfg = _case(3, "ref")
    y, train = inputs.labels(256, MODEL["n_classes"], 0.66, 3, "cpu")
    keys = sorted(p0)
    mine = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    ref = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    tc = TrainConfig(**HP)
    state = adamw.adamw_init(mine, tc)
    opt = reference.AdamW(ref, HP)
    for _ in range(4):
        logits = gcn.gcn_forward_full(mine, x, *edges, cfg)[0]
        loss = reference.loss(logits, y, train)
        g = torch.autograd.grad(loss, [mine[k] for k in keys])
        adamw.adamw_update(mine, dict(zip(keys, g)), state, tc)
        rloss = reference.loss(reference.forward(ref, x[0], src, dst, w, 2),
                               y, train)
        rg = torch.autograd.grad(rloss, [ref[k] for k in keys])
        for a, b in zip(g, rg):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        opt.step(ref, dict(zip(keys, rg)))
        torch.testing.assert_close(loss, rloss, rtol=1e-6, atol=1e-6)
    for k in keys:
        torch.testing.assert_close(mine[k], ref[k], rtol=1e-6, atol=1e-7)
    assert int(state["count"]) == opt.count == 4
