"""A cell's inputs, made on the device from the seed.

The graph is the Graph500 R-MAT draw (A, B, C from the configuration; the
generator behind the paper's Fig 16(b) "G500" graphs), written for the
device: one uniform draw per bit of the vertex id, over all edges at once.
It follows ``repro_torch.graph.synthetic.rmat`` (no vertex permutation,
duplicate edges and self loops kept, weights uniform in [0.05, 1.05)), but
is the benchmark's own copy and draws from a ``torch.Generator``, so its
numbers differ from that numpy draw.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's draws; any
    whole ``seed`` (also past 64 bits) gives a valid, distinct state."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def rmat(scale: int, edge_factor: int, a: float, b: float, c: float,
         gen: torch.Generator, device) -> tuple:
    """(src, dst, weights) of an R-MAT graph with 2^scale vertices and
    edge_factor · 2^scale edges: int32, int32, float32 on ``device``."""
    m = edge_factor << scale
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        right = (r >= a) & (r < a + b)         # B quadrant: dst bit
        down = (r >= a + b) & (r < a + b + c)  # C quadrant: src bit
        diag = r >= a + b + c                  # D quadrant: both
        src |= (down | diag).to(torch.int32) << bit
        dst |= (right | diag).to(torch.int32) << bit
        del r, right, down, diag
    w = torch.rand(m, generator=gen, device=device) + 0.05
    return src, dst, w


def graph(config: dict, seed: int, device) -> tuple:
    g = config["graph"]
    return rmat(g["scale"], g["edge_factor"], g["a"], g["b"], g["c"],
                generator(seed, 0, device), device)


def widths(model: dict) -> list:
    """The input width of each aggregation layer."""
    return [model["n_features"]] + [model["hidden"]] * (model["n_layers"] - 1)


def params(model: dict, seed: int, device) -> dict:
    """The model's parameters as ``repro_torch.core.gcn.gcn_schema`` names
    and shapes them: each weight (fan_in, fan_out) normal with standard
    deviation fan_in^-1/2, each bias normal with standard deviation 0.1.
    One draw for all of them, split by leaf."""
    H, C = model["hidden"], model["n_classes"]
    shapes = {}
    for i, f in enumerate(widths(model)):
        shapes[f"w{i}"] = (2 * f, H)
        shapes[f"b{i}"] = (H,)
    shapes["w_out"] = (H, C)
    shapes["b_out"] = (C,)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, 1, device),
                       device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        std = shape[0] ** -0.5 if len(shape) == 2 else 0.1
        out[name] = (part * std).reshape(shape).contiguous()
    return out


def tables(n: int, V: int, F: int, seed: int, device) -> torch.Tensor:
    """``n`` vertex feature tables, (n, V, F) standard normal."""
    return torch.randn((n, V, F), generator=generator(seed, 2, device),
                       device=device)


def labels(V: int, C: int, share: float, seed: int, device) -> tuple:
    """(labels (V,) int64 in [0, C), the sorted training vertices: the
    first round(share · V) of a random permutation)."""
    gen = generator(seed, 3, device)
    y = torch.randint(0, C, (V,), generator=gen, device=device)
    n = int(round(share * V))
    idx = torch.randperm(V, generator=gen, device=device)[:n]
    return y, torch.sort(idx).values


def program_edges(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                  V: int) -> tuple:
    """The program's own layout of the edges, one partition on one card:
    ``repro_torch.graph.partition.partition_by_src`` on the host, its
    (1, E) source, destination, weight and mask arrays back on the
    edges' device."""
    from repro_torch.graph import partition
    from repro_torch.graph.structure import COOGraph

    pg = partition.partition_by_src(
        COOGraph(V, src.cpu().numpy(), dst.cpu().numpy(), w.cpu().numpy()),
        1)
    return tuple(torch.from_numpy(a).to(src.device) for a in
                 (pg.src, pg.dst, pg.weights, pg.mask))
