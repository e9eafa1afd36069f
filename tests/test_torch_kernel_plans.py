"""Port: the host-side launch plans of the redesigned kernels.

What a CUDA kernel computes is checked on the card (``chip_smoke.py``);
what its wrapper decides on the host is checked here, on the CPU:

* flash attention: the route follows the dtype (bfloat16 on the tensor
  cores, float32 on the CUDA cores), the head dim pads to a template
  instance, and each plan's shared memory fits one block's 232,448 bytes;
* the banded GAS walk: the cluster size from ``W`` and ``n_rows`` alone,
  and the split of each row block's run over the cluster's CTAs. A Python
  model of that split — each rank reduces its share into a partial from
  the identity, the partials combine in rank order — equals the plain
  version bit for bit on integer data, so the kernel's partition computes
  the same function as the sequential walk;
* the dense GAS grid: the cluster size from ``T`` and ``n_rows`` alone,
  and a Python model of the kernel's integer logic — the occupied tiles
  compacted in windows of 256, each rank's share of their 32-edge chunks,
  the rank-order combine — equal to the plain version bit for bit on
  integer data (NaN cells in place for max and min).
"""

import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.gas_scatter import kernel as K
from repro_torch.kernels.gas_scatter import ops

SMEM_LIMIT = 232_448


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma_bf16"),
                                         (torch.float32, "fma_f32")])
def test_flash_route_follows_dtype(dtype, route):
    for hd in range(8, 257, 8):
        plan = FK.flash_plan(dtype, hd)
        assert plan.route == route
        assert hd <= plan.head_pad <= max(16, 2 * hd)
        assert plan.head_pad in (16, 32, 64, 128, 256)
    with pytest.raises(TypeError, match="no flash route"):
        FK.flash_plan(torch.float16, 64)


@pytest.mark.parametrize("dtype,hd,want", [
    # (route, head pad, block_q, block_k, threads, shared bytes)
    (torch.bfloat16, 8, ("mma_bf16", 16, 64, 64, 128, 15_360)),
    (torch.bfloat16, 64, ("mma_bf16", 64, 64, 64, 128, 46_080)),
    (torch.bfloat16, 256, ("mma_bf16", 256, 64, 32, 128, 101_376)),
    (torch.float32, 8, ("fma_f32", 16, 64, 64, 256, 25_856)),
    (torch.float32, 64, ("fma_f32", 64, 64, 64, 256, 68_608)),
    (torch.float32, 256, ("fma_f32", 256, 64, 64, 256, 222_208)),
])
def test_flash_plan_shared_memory_fits(dtype, hd, want):
    plan = FK.flash_plan(dtype, hd)
    assert tuple(plan) == want
    assert plan.smem_bytes <= SMEM_LIMIT
    if plan.route == "mma_bf16":
        # q tile + two stages of k and v, rows padded by 8 bf16 elements
        rows = plan.block_q + 2 * 2 * plan.block_k
        assert plan.smem_bytes == 2 * rows * (plan.head_pad + 8)
        # 16 extra bytes a row: the 8 rows of one ldmatrix phase start on
        # 8 distinct 16-byte bank groups
        stride = 2 * (plan.head_pad + 8)
        assert len({(r * stride // 16) % 8 for r in range(8)}) == 8


@pytest.mark.parametrize("hd", [0, 12, 264])
def test_flash_plan_rejects_head_dims_it_does_not_build(hd):
    with pytest.raises(ValueError, match="multiple of 8"):
        FK.flash_plan(torch.bfloat16, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cpu_call_launches_no_route(dtype):
    """On CPU tensors the wrapper runs the plain version: a call, and no
    launch on either route."""
    FK.reset_launch_counts()
    q = torch.zeros((2, 128, 16), dtype=dtype)
    FK.flash_attention_fwd(q, q, q, causal=True, window=0, softcap=0.0,
                           kv_len=128, n_kv_heads=1)
    assert FK.route_launch_counts() == {"mma_bf16": 0, "fma_f32": 0}
    assert FK.flash_attention_plain.calls == 1
    FK.reset_launch_counts()
    assert FK.flash_attention_plain.calls == 0


# ---------------------------------------------------------------------------
# the banded GAS walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W,n_rows,F,cluster", [
    (9, 128, 608, 8),      # one inference chunk: 8 x 19 = 152 CTAs
    (4, 128, 608, 4),      # a 3-seed serving segment: W below the limit
    (2, 128, 32, 2),       # W smaller than the largest cluster
    (0, 128, 32, 1),       # an empty work list still launches one CTA
    (42, 128, 64, 8),      # more live rounds than the cluster has CTAs
    (40, 1024, 96, 5),     # eight row blocks, ~5 rows each
])
def test_banded_plan_cluster_size(W, n_rows, F, cluster):
    plan = K.banded_plan(W, n_rows, F)
    assert plan.cluster == cluster
    assert plan.grid == (n_rows // 128 * cluster, F // 32)
    assert plan.threads == 256
    assert plan.smem_bytes == K.BANDED_SMEM <= SMEM_LIMIT
    if (W, n_rows, F) == (9, 128, 608):
        assert plan.grid[0] * plan.grid[1] >= 132


@pytest.mark.parametrize("lo,hi,cluster", [(0, 9, 8), (3, 5, 8), (0, 42, 8),
                                           (7, 7, 4), (2, 30, 3),
                                           # dense: chunks of 2 tiles, 1 tile
                                           (0, 8, 8), (0, 4, 8)])
def test_cluster_shares_split_the_run_in_order(lo, hi, cluster):
    shares = [K.cluster_share(lo, hi, r, cluster) for r in range(cluster)]
    assert shares[0][0] == lo and shares[-1][1] == hi
    for (a0, a1), (b0, _) in zip(shares, shares[1:]):
        assert a0 <= a1 == b0                 # contiguous, in rank order
    sizes = [b - a for a, b in shares]
    assert max(sizes) - min(sizes) <= 1
    if hi - lo < cluster:
        assert sizes.count(0) == cluster - (hi - lo)


def _identity(op):
    return {"add": 0.0, "max": float("-inf"), "min": float("inf")}[op]


def _combine(op, a, b):
    if op == "add":
        return a + b
    return torch.maximum(a, b) if op == "max" else torch.minimum(a, b)


def _cluster_walk(work, dst, values, n_rows, op, weights):
    """The kernel's partition of the walk, in PyTorch: per row block, each
    rank of ``banded_plan``'s cluster reduces its ``cluster_share`` of the
    run's live rows into a partial from the identity; the partials combine
    in rank order."""
    E, F = values.shape
    plan = K.banded_plan(work.shape[0], n_rows, F)
    rows = work.tolist()
    blocks = work[:, 0].contiguous()
    out = torch.empty((n_rows, F))
    feat_skip = work.shape[1] > 4
    for rb in range(n_rows // 128):
        lo = int(torch.searchsorted(blocks, rb))
        hi = int(torch.searchsorted(blocks, rb + 1))
        parts = []
        for rank in range(plan.cluster):
            s0, s1 = K.cluster_share(lo, hi, rank, plan.cluster)
            acc = torch.full((128, F), _identity(op))
            for i in range(s0, s1):
                if rows[i][2] != 1:
                    continue
                fl = torch.tensor(rows[i][4:]) if feat_skip else None
                K._round_plain(acc, dst, values, weights, op, rows[i][1],
                               rb * 128, fl)
            parts.append(acc)
        acc = parts[0]
        for p in parts[1:]:
            acc = _combine(op, acc, p)
        out[rb * 128:(rb + 1) * 128] = acc
    return out


def _run_banded_plain(*args, **kwargs):
    return K.gas_scatter_banded_plain(*args, **kwargs)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("seeds,fanout,n_rows", [
    (16, 50, 16),      # one inference chunk's shape: W = 9, cluster 8
    (100, 50, 100),    # one row block, 40 live rounds over 8 CTAs
    (3, 50, 3),        # W = 4: a cluster of 4, one CTA idle
    (300, 7, 300),     # three row blocks
    (40, 50, 600),     # five row blocks, four of them empty
])
def test_cluster_walk_equals_the_plain_walk(op, seeds, fanout, n_rows):
    rng = np.random.default_rng(seeds * 7 + fanout)
    E = seeds * fanout
    dst = torch.arange(seeds, dtype=torch.int32).repeat_interleave(fanout)
    mask = torch.from_numpy(rng.random(E) < 0.9)
    vals = rng.integers(-6, 7, (E, 64)).astype(np.float32)
    vals[:, 32:] = 0.0 if op == "add" else vals[:, 32:]   # a dead block
    vals = torch.from_numpy(vals)
    w = (torch.from_numpy(rng.integers(-3, 4, E).astype(np.float32))
         if op == "add" else None)
    sched = ops.schedule_edges(dst, mask, n_rows, assume_sorted=True)
    call = ops.fused_call(dst, vals, w, mask, n_rows, op=op, schedule=sched)
    work, dstp, valp, R = call.args
    if op == "add":
        assert work.shape[1] == 4 + 2 and not work[:, 5].any()
    want = _run_banded_plain(*call.args, **call.kwargs)
    got = _cluster_walk(work, dstp, valp, R, op, call.kwargs["weights"])
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the dense GAS grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,n_rows,F,cluster", [
    (2, 128, 608, 8),      # one 3-seed serving segment: 8 x 19 = 152 CTAs
    (7, 128, 608, 8),      # one inference chunk's segment: 28 chunks
    (520, 1024, 608, 8),   # large T over eight row blocks
    (1, 128 * 64, 32, 4),  # one tile over 64 row blocks: its 4 chunks
    (0, 128, 32, 1),       # no edge tile: a cluster of one
    (0, 0, 32, 1),         # no row block at all
])
def test_dense_plan_cluster_size(T, n_rows, F, cluster):
    plan = K.dense_plan(T, n_rows, F)
    assert plan.cluster == cluster
    assert plan.grid == (n_rows // 128 * cluster, F // 32)
    assert plan.threads == 256
    assert plan.smem_bytes == K.BANDED_SMEM <= SMEM_LIMIT
    if (T, n_rows, F) == (2, 128, 608):
        assert plan.grid[0] * plan.grid[1] >= 132


def _chunk_round(acc, dst, values, weights, op, tile, lo, hi, row0):
    """Chunks [lo, hi) of one edge tile, reduced into a row block's
    partial, as the owner warps apply them."""
    sl = slice(tile * 128 + lo * K.CHUNK, tile * 128 + hi * K.CHUNK)
    rel = dst[sl].long() - row0
    hit = (rel >= 0) & (rel < 128)
    contrib = values[sl]
    if weights is not None:
        contrib = contrib * weights[sl, None]
    K._reduce_rows(acc, rel[hit], contrib[hit], op)


def _dense_rounds(row, T, c0, c1):
    """The rounds (tile, first chunk, end chunk) of chunks [c0, c1) of a
    row block's occupied tiles, compacted as the kernel does: windows of
    256 tiles, each occupied tile's index k from a prefix over the window,
    ``base`` occupied tiles before it."""
    chunks = K.EDGE_TILE // K.CHUNK
    k0 = c0 // chunks
    k1 = -(-c1 // chunks) if c1 > c0 else k0
    window = K.BANDED_WINDOW
    rounds, base = [], 0
    for t0 in range(0, T, window):
        if base >= k1:
            break
        flags = [t < T and row[t] > 0 for t in range(t0, t0 + window)]
        listed = [None] * window
        k = base
        for j, occupied in enumerate(flags):
            if occupied and k0 <= k < k1:
                c = chunks * k
                listed[k - max(k0, base)] = (t0 + j, max(c0 - c, 0),
                                             min(c1 - c, chunks))
            k += occupied
        cnt = sum(flags)
        total = max(min(base + cnt, k1) - max(base, k0), 0)
        assert None not in listed[:total]
        rounds += listed[:total]
        base += cnt
    return rounds


def _dense_cluster_walk(dst, values, occ, n_rows, op, weights):
    """The dense kernel's partition, in PyTorch: per row block, rank r of
    ``dense_plan``'s cluster reduces its ``cluster_share`` of the occupied
    tiles' 32-edge chunks into a partial from the identity; the partials
    combine in rank order."""
    E, F = values.shape
    T = E // 128
    plan = K.dense_plan(T, n_rows, F)
    out = torch.empty((n_rows, F))
    for rb in range(n_rows // 128):
        row = occ[rb].tolist()
        n_chunks = K.EDGE_TILE // K.CHUNK * sum(o > 0 for o in row)
        parts, seen = [], []
        for rank in range(plan.cluster):
            c0, c1 = K.cluster_share(0, n_chunks, rank, plan.cluster)
            acc = torch.full((128, F), _identity(op))
            for tile, lo, hi in _dense_rounds(row, T, c0, c1):
                assert 0 <= lo < hi <= 4
                seen += [(tile, c) for c in range(lo, hi)]
                _chunk_round(acc, dst, values, weights, op, tile, lo, hi,
                             rb * 128)
            parts.append(acc)
        # every chunk of every occupied tile once, in stream order
        assert seen == [(t, c) for t in range(T) if row[t] > 0
                        for c in range(4)]
        acc = parts[0]
        for p in parts[1:]:
            acc = _combine(op, acc, p)
        out[rb * 128:(rb + 1) * 128] = acc
    return out


def _run_dense_plain(*args, **kwargs):
    return K.gas_scatter_dense_plain(*args, **kwargs)


@pytest.mark.parametrize("op,weights", [("add", "unit"), ("add", "int"),
                                        ("max", None), ("min", None)])
@pytest.mark.parametrize("case", [
    "skewed",          # one 3-seed serving segment: every edge on 3 rows
    "empty_blocks",    # five row blocks, four of them empty
    "large_sorted",    # T = 520 over eight row blocks, dst ascending
    "large_shuffled",  # the same, dst in no order: every tile occupied
])
def test_dense_cluster_walk_equals_the_plain_walk(op, weights, case):
    rng = np.random.default_rng(zlib.crc32(f"{op} {weights} {case}".encode()))
    if case == "skewed":
        E, n_rows = 150, 3
        dst = np.repeat(np.arange(3), 50)
    elif case == "empty_blocks":
        E, n_rows = 500, 600
        dst = rng.integers(0, 40, E)
    else:
        E, n_rows = 520 * 128 - 37, 1024
        dst = rng.integers(0, n_rows, E)
        if case == "large_sorted":
            dst = np.sort(dst)
    mask = torch.from_numpy(rng.random(E) < 0.9)
    vals = rng.integers(-6, 7, (E, 64)).astype(np.float32)
    if op != "add":
        vals[::97, ::13] = np.nan
    w = None
    if op == "add":
        w = (torch.ones(E) if weights == "unit" else
             torch.from_numpy(rng.integers(-3, 4, E).astype(np.float32)))
    call = ops.fused_call(torch.from_numpy(dst.astype(np.int32)),
                          torch.from_numpy(vals), w, mask, n_rows, op=op)
    assert call.kernel == "gas_scatter_dense"
    dstp, valp, occ, R = call.args
    if case.startswith("large"):
        assert valp.shape[0] // 128 >= 512 and R // 128 >= 8
    want = _run_dense_plain(*call.args, **call.kwargs)
    got = _dense_cluster_walk(dstp, valp, occ, R, op, call.kwargs["weights"])
    if op != "add":
        assert torch.isnan(want).any()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
