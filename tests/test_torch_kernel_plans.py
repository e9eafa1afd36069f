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
  the same function as the sequential walk.
"""

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
                                           (7, 7, 4), (2, 30, 3)])
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
