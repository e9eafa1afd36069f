"""Training launcher: GraphSAGE with the CGTrans dataflow on one card.

``--workload graph`` (the default) is the one-card form of
``examples/train_graphsage.py``: an R-MAT graph with random features and
learnable synthetic labels, one partition holding the whole feature table,
batches carrying ids only, AdamW with warmup and cosine decay, and the
fault-tolerant loop (checkpoint + resume, straggler monitor, preemption
guard). It closes with the loss and accuracy on a fresh batch::

    PYTHONPATH=src python -m repro_torch.launch.train --steps 300

Runs on the card by default; ``--device cpu`` runs the same path on the
CPU (the kernels' plain versions). ``--workload lm`` (the JAX launcher's
LM training) is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch


def _main_graph(args) -> int:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.schema import count_params, init_params
    from repro_torch.core.gcn import (GCNConfig, feature_table, gcn_schema,
                                      sage_loss)
    from repro_torch.data import GraphBatchStream, synthetic_node_labels
    from repro_torch.device import resolve_device
    from repro_torch.graph import rmat
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import PreemptionGuard, StepMonitor
    from repro_torch.train import make_sage_train_step, train_loop

    dev = resolve_device(args.device)
    g = rmat(args.scale, 16, seed=0)
    rng = np.random.default_rng(1)
    g.features = rng.standard_normal(
        (g.n_vertices, args.features)).astype(np.float32)
    labels = synthetic_node_labels(g.features, 16)
    feats = feature_table(g.features, 1, device=dev)
    print(f"graph: {g.n_vertices} vertices, {g.n_edges} edges; features "
          f"{tuple(feats.shape)} on {dev} (one partition)")

    cfg = GCNConfig(n_features=args.features, hidden=args.hidden,
                    n_classes=16, fanout=args.fanout, dataflow=args.dataflow,
                    impl=args.impl, request_chunk=args.request_chunk,
                    coalesce=not args.no_coalesce)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=20,
                     total_steps=args.steps, weight_decay=0.01)
    params = init_params(gcn_schema(cfg), 0, device=dev)
    print(f"model: {count_params(gcn_schema(cfg)) / 1e6:.2f}M params "
          f"(+{feats.numel() / 1e6:.1f}M feature table), "
          f"dataflow={args.dataflow} impl={args.impl}")

    stream = GraphBatchStream(g, labels, n_parts=1,
                              batch_per_part=args.batch_per_part,
                              k1=args.fanout, k2=args.fanout)
    step = make_sage_train_step(cfg, tc, feats=feats)
    state = {"params": params, "opt": adamw_init(params, tc),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def batches():
        for b in stream:
            yield {k: torch.from_numpy(np.array(v)).to(dev)
                   for k, v in b.items()}

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "graphsage_ckpt")
    state, n = train_loop(
        step_fn=step, state=state, batches=batches(),
        total_steps=args.steps,
        ckpt=CheckpointManager(ckpt_dir, keep=2), ckpt_every=100,
        monitor=StepMonitor(), guard=PreemptionGuard(), log_every=20)

    # final eval on a fresh batch
    with torch.no_grad():
        _, m = sage_loss(state["params"], feats, stream.batch_at(10_000), cfg)
    print(f"done at step {n}: eval loss {float(m['loss']):.4f} "
          f"acc {float(m['acc']):.3f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("graph", "lm"), default="graph")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", type=int, default=14,
                    help="R-MAT scale (2^scale vertices)")
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--batch-per-part", type=int, default=64)
    ap.add_argument("--dataflow", choices=["cgtrans", "baseline"],
                    default="cgtrans")
    ap.add_argument("--impl", choices=["kernel", "ref"], default="kernel",
                    help="GAS backend for every aggregation: kernel runs "
                         "the FAST-GAS kernels (their plain versions on "
                         "the CPU), ref the index_add_ / scatter_reduce "
                         "oracle")
    ap.add_argument("--request-chunk", type=int, default=None,
                    help="SSD command-queue depth: seeds per sampled-"
                         "aggregation request burst (None = unchunked)")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="issue the self-row lookup and the 2-hop "
                         "aggregation as two request streams instead of "
                         "ONE coalesced command block")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: graphsage_ckpt "
                         "under the temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.workload == "lm":
        raise NotImplementedError(
            "--workload lm: LM training (transformer.loss_fn, "
            "train.step.make_train_step) is not ported yet (ROADMAP "
            "Queue 1 row 10)")
    return _main_graph(args)


if __name__ == "__main__":
    sys.exit(main())
