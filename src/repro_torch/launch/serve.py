"""Serving launcher: two workloads behind one front door.

* ``--workload graph`` (the default here; the JAX launcher defaults to
  ``lm``): the GraphSAGE serving engine under synthetic multi-tenant
  traffic. Concurrent callers with zipf-skewed seed popularity enqueue
  into the size-or-deadline ``RequestQueue``; every drain fuses the
  pending requests into ONE ``aggregate_multi`` command block, the
  hot-vertex cache absorbs repeat self-row lookups, and the run closes
  with the engine's health snapshot::

      PYTHONPATH=src python -m repro_torch.launch.serve \\
          --requests 48 --tenants 4 --cache 32 --batch 8

  ``--shards N --backend {nccl,gloo}`` serves from N ranks of a ``data``
  mesh, each holding its interval of the table; every rank replays the
  same traffic and rank 0 prints (``launch.train`` says which backend
  runs where).

* ``--workload lm``: batched prefill + greedy decode of an LM
  (``--arch``, any of the ten; parameters drawn on the device from
  ``--seed``), with tokens and, for an encoder-decoder or a vision model,
  frames or patch embeddings drawn from ``--seed``. ``--impl kernel``
  runs the encoder's and the prefill's self-attention through the flash
  kernel; ``--impl ref`` takes the plain chunked attention, the
  path the JAX launcher takes::

      PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
          --arch whisper-base --batch 4 --prompt-len 48 --gen 24

Both run on the card by default; ``--device cpu`` runs the same path on
the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# the deadline of a sharded graph run, and of each collective in it
SHARDED_RUN_TIMEOUT_S = 3600.0


def zipf_popularity(n_vertices: int, rng: np.random.Generator) -> np.ndarray:
    """Zipf-skewed seed popularity over a permuted rank order — the hot-set
    concentration the hot-vertex cache exploits."""
    order = rng.permutation(n_vertices)
    p = np.empty(n_vertices)
    p[order] = 1.0 / (np.arange(n_vertices) + 1.0)
    return p / p.sum()


def replay_traffic(eng, *, requests: int, tenants: int,
                   seed: int = 0) -> Tuple[List[int], List[int]]:
    """Submit ``requests`` queries of 1–3 zipf-drawn seeds, round-robin over
    ``tenants``, polling after each submit and flushing at the end.
    Returns (request ids in submit order, requests per tenant)."""
    rng = np.random.default_rng(seed)
    V = eng.n_vertices
    p = zipf_popularity(V, rng)
    rids, per_tenant = [], [0] * tenants
    for i in range(requests):
        n_seeds = int(rng.integers(1, 4))
        seeds = rng.choice(V, n_seeds, p=p)
        tenant = i % tenants
        rids.append(eng.submit(seeds, tenant=tenant))
        per_tenant[tenant] += 1
        eng.poll()                    # dispatches when size/deadline fires
    eng.flush()
    return rids, per_tenant


def lm_batch(cfg, batch: int, prompt_len: int, seed: int = 0
             ) -> Dict[str, np.ndarray]:
    """Prompt tokens (batch, prompt_len) int32 and, for an
    encoder-decoder, stub frame embeddings (batch, enc_seq, d_model), for
    a vision model stub patch embeddings (batch, vision_seq, d_model),
    float32, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, prompt_len)
                                  ).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    if cfg.vision_seq:
        out["vision"] = rng.standard_normal(
            (batch, cfg.vision_seq, cfg.d_model), dtype=np.float32)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params, batch: Dict[str, Any], cfg, *, gen: int,
             use_flash: bool, forced: Optional[torch.Tensor] = None
             ) -> Dict[str, Any]:
    """Prefill, then ``gen - 1`` greedy decode steps. ``forced`` (B, gen)
    teacher-forces the decode inputs (step i reads ``forced[:, i]``)
    instead of the greedy tokens. Returns the prefill and per-step logits,
    the greedy tokens (B, gen), and the host-clock seconds of the prefill
    and of the decode loop, each ending in a device synchronise. Runs
    without autograd: no output requires grad, even where params do."""
    from repro_torch.train import make_decode_step, make_prefill_step

    dev = params["embed"]["table"].device
    P = batch["tokens"].shape[1]
    prefill = make_prefill_step(cfg, cache_len=P + gen, use_flash=use_flash)
    decode = make_decode_step(cfg)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in batch.items()}
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out_logits = [logits]
    tok = logits.argmax(-1, keepdim=True)
    tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        feed = tok if forced is None else forced[:, i:i + 1]
        logits, caches = decode(params, feed, caches, P + i)
        out_logits.append(logits)
        tok = logits.argmax(-1, keepdim=True)
        tokens.append(tok)
    _sync(dev)
    return {"logits": out_logits, "tokens": torch.cat(tokens, dim=1),
            "prefill_s": t_prefill, "decode_s": time.perf_counter() - t0}


def _main_lm(args) -> int:
    from repro_torch import configs
    from repro_torch.common.schema import init_params
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T

    dev = resolve_device(args.device)
    if not args.arch:
        print("--workload lm requires --arch", file=sys.stderr)
        return 2
    cfg = (configs.smoke_config(args.arch) if args.reduced
           else configs.get_config(args.arch))
    params = init_params(T.model_schema(cfg, max_seq=args.prompt_len
                                        + args.gen), args.seed, device=dev,
                         draw="device")
    batch = lm_batch(cfg, args.batch, args.prompt_len, args.seed)
    out = generate(params, batch, cfg, gen=args.gen,
                   use_flash=args.impl == "kernel")
    steps = max(args.gen - 1, 1)
    toks = args.batch * (args.gen - 1)
    print(f"{cfg.name} on {dev} impl={args.impl}: prefill "
          f"{args.batch}x{args.prompt_len} tokens in "
          f"{out['prefill_s'] * 1e3:.1f} ms")
    print(f"decode: {toks} tokens in {out['decode_s'] * 1e3:.1f} ms "
          f"({toks / max(out['decode_s'], 1e-9):.1f} tok/s batch, "
          f"{out['decode_s'] * 1e3 / steps:.2f} ms/step)")
    print("generated ids[0]:", out["tokens"][0].tolist())
    return 0


def _serve_graph(mesh, args) -> int:
    """The run on one rank (``mesh`` a ``DataMesh``) or unsharded
    (``mesh=None``)."""
    from repro_torch.graph import uniform_graph
    from repro_torch.serving import ServingEngine

    print_ = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    V = args.vertices
    g = uniform_graph(V, args.degree * V, seed=args.seed,
                      n_features=args.features)
    indptr, indices, _ = g.to_csr()

    eng = ServingEngine(g.features, indptr, indices, fanout=args.fanout,
                        max_batch=args.batch,
                        max_delay_s=args.max_delay_ms / 1e3,
                        cache_capacity=args.cache, sample_seed=args.seed,
                        impl=args.impl, mesh=mesh, device=args.device)
    print_(f"graph serving on {eng.device} x {eng.n_shards} shard(s): "
           f"V={V} E={args.degree * V} F={args.features} "
           f"fanout={args.fanout} impl={args.impl} | "
           f"batch={args.batch} deadline={args.max_delay_ms}ms "
           f"cache={args.cache} tenants={args.tenants}")

    t0 = time.perf_counter()
    rids, per_tenant = replay_traffic(eng, requests=args.requests,
                                      tenants=args.tenants, seed=args.seed)
    served = eng.stats["queries"]
    dt = time.perf_counter() - t0

    snap = eng.health_snapshot()
    stats = snap["stats"]
    print_(f"served {served}/{args.requests} requests "
           f"({', '.join(f't{t}:{n}' for t, n in enumerate(per_tenant))}) "
           f"in {dt * 1e3:.1f} ms")
    print_(f"command blocks: {stats['command_blocks']} "
           f"({stats['queries'] / max(stats['command_blocks'], 1):.1f} "
           f"queries/block) | finds: {stats['find']} "
           f"({snap['finds_per_query']:.3f}/query vs 1.000 naive) | "
           f"kernel scatters: {stats['kernel_scatter']}")
    if "cache" in snap:
        c = snap["cache"]
        print_(f"hot cache: {c['hits']}/{c['hits'] + c['misses']} lookups hit "
              f"(rate {c['hit_rate']:.2f}), {c['resident']}/{c['capacity']} "
              f"rows resident, {c['evictions']} evictions")
    mon = snap["monitor"]
    print_(f"health: {mon['steps']} dispatches recorded "
           f"({mon['flagged']} flagged), ewma "
           f"{mon['ewma_s'] * 1e3:.1f} ms/dispatch, "
           f"queue depth {snap['queue_depth']}")
    return 0 if served == args.requests else 1


def _main_graph(args) -> int:
    if args.shards == 1:
        return _serve_graph(None, args)
    from repro_torch.launch.mesh import spawn
    if args.backend == "nccl" and torch.cuda.device_count() < args.shards:
        raise RuntimeError(
            f"--backend nccl needs one card per shard ({args.shards} "
            f"shards, {torch.cuda.device_count()} card(s)); pass --backend "
            f"gloo to run the shards on a shared card or on the CPU")
    return max(spawn(_serve_graph, args.shards, backend=args.backend,
                     device=args.device, timeout_s=SHARDED_RUN_TIMEOUT_S,
                     args=(args,)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "graph"), default="graph")
    # lm workload
    ap.add_argument("--arch")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    # graph workload
    ap.add_argument("--batch", type=int, default=8,
                    help="graph: queue max_batch; lm: prefill batch")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--vertices", type=int, default=256)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--cache", type=int, default=32,
                    help="hot-vertex cache capacity (0 disables)")
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--impl", choices=("kernel", "ref"), default="kernel")
    ap.add_argument("--shards", type=int, default=1,
                    help="graph: data-axis ranks, each owning an interval "
                         "of the table")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="graph, sharded: nccl needs one card per shard; "
                         "gloo runs CPU ranks or ranks sharing one card")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return _main_lm(args) if args.workload == "lm" else _main_graph(args)


if __name__ == "__main__":
    sys.exit(main())
