"""Training launcher: GraphSAGE with the CGTrans dataflow, or an LM.

``--workload graph`` (the default) is ``examples/train_graphsage.py``: an
R-MAT graph with random features and learnable synthetic labels, the
feature table owner-sharded over ``--shards`` partitions, batches carrying
ids only, AdamW with warmup and cosine decay, and the fault-tolerant loop
(checkpoint + resume, straggler monitor, preemption guard). It closes with
the loss and accuracy on a fresh batch::

    PYTHONPATH=src python -m repro_torch.launch.train --steps 300

``--shards N`` (N > 1) runs N ranks on a ``data`` mesh
(``repro_torch.launch.mesh``), each holding its interval of the table and
its slice of every batch; rank 0 prints. ``--backend nccl`` (the default)
needs one card per rank; ``--backend gloo`` runs CPU ranks, or ranks that
share one card with every collective staged through host memory — the
8-way form of the example on the CPU is::

    PYTHONPATH=src python -m repro_torch.launch.train --shards 8 \
        --backend gloo --device cpu --steps 20 --scale 10

``--workload lm`` is the JAX launcher's LM training: ``--arch`` at its
published widths (``--reduced``: the same-family smoke size) on
``TokenStream`` batches of ``--batch`` × ``--seq-len`` tokens, AdamW with
warmup over the first tenth of ``--steps``, the fault-tolerant loop, and
checkpoints in ``--ckpt-dir`` when given (a rerun resumes from them)::

    PYTHONPATH=src python -m repro_torch.launch.train --workload lm \
        --arch qwen1.5-0.5b --steps 50

The parameters are drawn on the device (``init_params(draw="device")``).
``--dry-run`` traces one rank's step of ``--arch`` at ``--shape`` on the
(16, 16) production mesh (``--multi-pod``: the (2, 16, 16) one) on fake
tensors, in this process, and prints its record (``launch/dryrun.py``)::

    PYTHONPATH=src python -m repro_torch.launch.train --workload lm \
        --arch qwen1.5-0.5b --shape train_4k --dry-run

Runs on the card by default; ``--device cpu`` runs the same path on the
CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

# the deadline of a sharded run, and of each collective in it
SHARDED_RUN_TIMEOUT_S = 3600.0


def _train_graph(mesh, args) -> int:
    """The run on one rank (``mesh`` a ``DataMesh``) or unsharded
    (``mesh=None``)."""
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

    n = mesh.size if mesh is not None else 1
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    local = mesh.shard if mesh is not None else (lambda b: b)
    g = rmat(args.scale, 16, seed=0)
    rng = np.random.default_rng(1)
    g.features = rng.standard_normal(
        (g.n_vertices, args.features)).astype(np.float32)
    labels = synthetic_node_labels(g.features, 16)
    feats = feature_table(g.features, n, mesh=mesh, device=dev)
    say(f"graph: {g.n_vertices} vertices, {g.n_edges} edges; features "
        f"owner-sharded over {n} partition(s), {tuple(feats.shape)} per "
        f"rank on {dev}"
        + (f" ({mesh.backend})" if mesh is not None else ""))

    cfg = GCNConfig(n_features=args.features, hidden=args.hidden,
                    n_classes=16, fanout=args.fanout, dataflow=args.dataflow,
                    impl=args.impl, request_chunk=args.request_chunk,
                    coalesce=not args.no_coalesce)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=20,
                     total_steps=args.steps, weight_decay=0.01)
    params = init_params(gcn_schema(cfg), 0, device=dev)
    say(f"model: {count_params(gcn_schema(cfg)) / 1e6:.2f}M params "
        f"(+{feats.numel() * n / 1e6:.1f}M feature table), "
        f"dataflow={args.dataflow} impl={args.impl}")

    stream = GraphBatchStream(g, labels, n_parts=n,
                              batch_per_part=args.batch_per_part,
                              k1=args.fanout, k2=args.fanout)
    step = make_sage_train_step(cfg, tc, feats=feats, mesh=mesh)
    state = {"params": params, "opt": adamw_init(params, tc),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def batches():
        for b in stream:
            yield {k: torch.from_numpy(np.array(v)).to(dev)
                   for k, v in local(b).items()}

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "graphsage_ckpt")
    state, done = train_loop(
        step_fn=step, state=state, batches=batches(),
        total_steps=args.steps,
        ckpt=CheckpointManager(ckpt_dir, keep=2, mesh=mesh), ckpt_every=100,
        monitor=StepMonitor(), guard=PreemptionGuard(), log_every=20,
        log_fn=say)

    # final eval on a fresh batch
    with torch.no_grad():
        _, m = sage_loss(state["params"], feats,
                         local(stream.batch_at(10_000)), cfg, mesh=mesh)
    say(f"done at step {done}: eval loss {float(m['loss']):.4f} "
        f"acc {float(m['acc']):.3f}")
    return 0


def _main_graph(args) -> int:
    if args.shards == 1:
        return _train_graph(None, args)
    from repro_torch.launch.mesh import spawn
    if args.backend == "nccl" and torch.cuda.device_count() < args.shards:
        raise RuntimeError(
            f"--backend nccl needs one card per shard ({args.shards} "
            f"shards, {torch.cuda.device_count()} card(s)); pass --backend "
            f"gloo to run the shards on a shared card or on the CPU")
    codes = spawn(_train_graph, args.shards, backend=args.backend,
                  device=args.device, timeout_s=SHARDED_RUN_TIMEOUT_S,
                  args=(args,))
    return max(codes)


def _main_lm(args) -> int:
    """The JAX launcher's LM loop, on one device, or the dry run of one
    production cell."""
    if not args.arch:
        print("--workload lm requires --arch", file=sys.stderr)
        return 2
    if args.dry_run or args.multi_pod:
        import json

        from repro_torch.launch import dryrun
        rec = dryrun.run_cell(args.arch, args.shape, args.multi_pod)
        print(json.dumps(rec, indent=1))
        return 0 if rec["ok"] else 1
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.schema import count_params
    from repro_torch.data import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.runtime import PreemptionGuard, StepMonitor
    from repro_torch.train import init_state, make_train_step, train_loop

    dev = resolve_device(args.device)
    steps = args.steps if args.steps is not None else 50
    cfg = (configs.smoke_config(args.arch) if args.reduced
           else configs.get_config(args.arch))
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=max(steps // 10, 1),
                     total_steps=steps,
                     grad_compression=args.grad_compression)
    stream = TokenStream(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq_len,
        with_frames=cfg.enc_seq if cfg.is_encoder_decoder else 0,
        with_vision=cfg.vision_seq, d_model=cfg.d_model)
    state = init_state(cfg, tc, tc.seed, max_seq=args.seq_len, device=dev,
                       draw="device")
    n_params = count_params(T.model_schema(cfg, max_seq=args.seq_len))
    print(f"{cfg.name}: {n_params / 1e6:.2f}M params on {dev}, "
          f"{args.batch} x {args.seq_len} tokens a step, compute "
          f"{cfg.compute_dtype}, remat {cfg.remat}")
    step = make_train_step(cfg, tc)

    def batches():
        for b in stream:
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state, n = train_loop(step_fn=step, state=state, batches=batches(),
                          total_steps=steps, ckpt=ckpt, ckpt_every=25,
                          monitor=StepMonitor(), guard=PreemptionGuard(),
                          log_every=10)
    print(f"finished at step {n}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("graph", "lm"), default="graph")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps to train (default: graph 300, lm 50)")
    # lm workload: the JAX launcher's flags
    ap.add_argument("--arch")
    ap.add_argument("--reduced", action="store_true",
                    help="lm: train the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--shape", default="train_4k",
                    help="lm dry run: the production shape to trace")
    ap.add_argument("--dry-run", action="store_true",
                    help="lm: trace one rank's step of --arch at --shape on "
                         "the production mesh (no card) and print the "
                         "record")
    ap.add_argument("--multi-pod", action="store_true",
                    help="lm dry run on the (2, 16, 16) mesh")
    # graph workload
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
                    help="checkpoint directory (graph default: "
                         "graphsage_ckpt under the temporary directory; lm "
                         "default: no checkpoints)")
    ap.add_argument("--shards", type=int, default=1,
                    help="data-axis ranks, each owning an interval of the "
                         "feature table")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="collectives of a sharded run: nccl needs one card "
                         "per shard; gloo runs CPU ranks or ranks sharing "
                         "one card, staging through host memory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.workload == "lm":
        return _main_lm(args)
    if args.steps is None:
        args.steps = 300
    return _main_graph(args)


if __name__ == "__main__":
    sys.exit(main())
