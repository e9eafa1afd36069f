"""Plain PyTorch reference of the cells' full-graph GraphSAGE, in float32.

It works from the raw COO graph the benchmark made (source, destination
and weight per edge) and from the benchmark's parameters and features;
it imports nothing of the program and takes nothing the program made.
Where the program partitions the edges by source owner and bins them by
destination row block, the reference needs neither: each aggregation is
``index_add_`` over the edges in their drawn order.

The model, as ``repro_torch.core.gcn.gcn_forward_full`` states it with
``aggregate="add"`` on one partition:

    agg_i[v] = Σ_{(u, v, w) ∈ E} w · h_i[u]
    h_{i+1}  = relu([h_i ‖ agg_i] W_i + b_i)
    logits   = h_L W_out + b_out

and training as the cells run it: the mean cross-entropy over the training
vertices, its gradients by autograd, then AdamW with the arithmetic of the
port's ``optim.adamw_update`` written out again here (``AdamW`` below):
global-norm clipping, a linear warm-up into a cosine decay, bias-corrected
moments, and decoupled weight decay ``p − lr·(step + wd·p)``.

Callers run it with TF32 off (``torch.backends.cuda.matmul.allow_tf32``),
as the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# edges per index_add_ block: bounds the (block, F) gathered rows
EDGE_BLOCK = 1 << 20


def aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              w: torch.Tensor, block: int = EDGE_BLOCK) -> torch.Tensor:
    """Σ over edges of w · h[src] into the rows dst; (V, F)."""
    out = torch.zeros_like(h)
    for lo in range(0, src.shape[0], block):
        s, d = src[lo:lo + block].long(), dst[lo:lo + block].long()
        out = out.index_add(0, d, h[s] * w[lo:lo + block, None])
    return out


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
            n_layers: int) -> torch.Tensor:
    """(V, C) logits of the features ``x`` (V, F)."""
    h = x
    for i in range(n_layers):
        agg = aggregate(h, src, dst, w)
        h = torch.relu(torch.cat([h, agg], dim=1) @ params[f"w{i}"]
                       + params[f"b{i}"])
    return h @ params["w_out"] + params["b_out"]


def loss(logits: torch.Tensor, labels: torch.Tensor,
         train: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the training vertices ``train``."""
    logp = torch.log_softmax(logits[train], dim=-1)
    return -logp.gather(1, labels[train][:, None]).mean()


class AdamW:
    """AdamW on a dict of float32 leaves, the hyperparameters of
    ``repro_torch.common.config.TrainConfig`` as the traffic file gives
    them."""

    def __init__(self, params: Dict[str, torch.Tensor], hp: dict):
        self.hp = hp
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def lr(self) -> float:
        hp, t = self.hp, float(self.count)
        warm = min(t / max(hp["warmup_steps"], 1), 1.0)
        prog = min(max((t - hp["warmup_steps"])
                       / max(hp["total_steps"] - hp["warmup_steps"], 1), 0.0),
                   1.0)
        cos = 0.5 * (1 + math.cos(math.pi * prog))
        scale = hp["min_lr_ratio"] + (1 - hp["min_lr_ratio"]) * cos
        return hp["learning_rate"] * warm * scale

    @staticmethod
    def clip(grads: Dict[str, torch.Tensor], max_norm: float):
        """The gradients scaled to a global norm of at most ``max_norm``."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return {k: g * scale for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        """Updates ``params`` in place."""
        hp = self.hp
        grads = self.clip(grads, hp["grad_clip"])
        self.count += 1
        lr = self.lr()
        b1, b2 = hp["beta1"], hp["beta2"]
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            step = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2)
                                        + hp["eps"])
            p.copy_(p - lr * (step + hp["weight_decay"] * p))
