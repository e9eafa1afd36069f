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
* the dense GAS grid: the cluster size from ``E`` and ``n_rows`` alone,
  and a Python model of the kernel's integer logic — each rank's share of
  the 32-edge chunks of its row block's run of the row-sorted stream,
  walked in rounds of 128 positions through ``order``, each round's
  16-position warp slices and their leading pieces folded in warp order,
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

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

SMEM_LIMIT = 232_448
NEG = FK.NEG_INF


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
    (torch.float32, 8, ("fma_f32", 16, 64, 64, 128, 46_080)),
    (torch.float32, 64, ("fma_f32", 64, 64, 64, 128, 107_520)),
    (torch.float32, 256, ("fma_f32", 256, 64, 32, 256, 211_968)),
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
    else:
        assert plan.smem_bytes == _f32_smem(plan)


# the shared memory of one SM (228 KB), and what each resident CTA reserves
SM_SMEM, CTA_RESERVED = 233_472, 1024


def _f32_smem(plan):
    """The f32 plan's shared bytes: the q tile and two stages of k and v
    (rows of head pad + 4 floats), then each warp's p slice (a row of
    rows-per-warp + 4 floats per key)."""
    warps = plan.threads // 32
    rows = plan.block_q // warps
    return 4 * ((plan.block_q + 2 * 2 * plan.block_k) * (plan.head_pad + 4)
                + warps * plan.block_k * (rows + 4))


@pytest.mark.parametrize("hd", range(8, 257, 8))
def test_flash_f32_plan_fits_and_is_conflict_free(hd):
    plan = FK.flash_plan(torch.float32, hd)
    assert plan.route == "fma_f32" and plan.block_q == 64
    assert plan.smem_bytes == _f32_smem(plan) <= SMEM_LIMIT
    # 16 extra bytes a q / k / v row: the 8 rows of one LDS.128 phase start
    # on 8 distinct 16-byte bank groups
    stride = 4 * (plan.head_pad + 4)
    assert len({(r * stride // 16) % 8 for r in range(8)}) == 8
    # and the 8 consecutive keys of a p store phase, likewise
    rows = plan.block_q // (plan.threads // 32)
    pstride = 4 * (rows + 4)
    assert len({(r * pstride // 16) % 8 for r in range(8)}) == 8
    if hd <= 64:
        # two CTAs (eight warps) fit on one SM
        assert 2 * (plan.smem_bytes + CTA_RESERVED) <= SM_SMEM
        assert 2 * plan.threads >= 256
    assert FK.flash_plan(torch.float32, hd) is plan   # cached


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


def _f32_kernel_model(q, k, v, *, causal, window, softcap, kv_len,
                      n_kv_heads):
    """A PyTorch model of ``flash_fwd_kernel``'s index logic, lane by lane:
    the plan's CTA tile, each warp's rows, the S layout (lane (rg, ds, kg):
    8 interleaved rows x 4 keys over every DS-th 16-byte chunk of the
    padded head dim, partial sums added over the ds lanes), the band and
    straddle masks, the warp's p slice (NaN where no lane stored), the P V
    layout (lane (rg, ks, cg): 8 rows x 4·NC columns over every KS-th key,
    accumulators added over the ks lanes at the end) and the lane that
    writes each output row (NaN where none did)."""
    BH, S, hd = q.shape
    T = k.shape[1]
    plan = FK.flash_plan(torch.float32, hd)
    HDP, BQ, BK = plan.head_pad, plan.block_q, plan.block_k
    warps = plan.threads // 32
    R = BQ // warps
    RG, KG = R // 8, BK // 4
    DS = 32 // (RG * KG)
    NC = 2                                  # 8 output columns a lane
    CG = HDP // (4 * NC)
    KS = 32 // (RG * CG)
    batch = k.shape[0] // n_kv_heads
    H = BH // batch
    lane = torch.arange(32)
    rg = lane // (32 // RG)
    ds, kg = (lane // KG) % DS, lane % KG
    kq, cg = (lane // CG) % KS, lane % CG
    i8, j4 = torch.arange(8), torch.arange(4)
    pad = lambda x: torch.nn.functional.pad(x, (0, HDP - hd))
    qp, kp, vp = pad(q), pad(k), pad(v)
    # the columns of each lane's S chunks and of its P V columns
    s_cols = (4 * (ds[:, None] + DS * torch.arange(HDP // 4 // DS))[:, :, None]
              + j4).reshape(32, -1)
    o_cols = (cg[:, None, None] * 4 + 4 * CG * torch.arange(NC)[:, None]
              + j4)                                          # (32, NC, 4)
    out = torch.full((BH, S, hd), float("nan"))
    for bh in range(BH):
        kvh = (bh // H) * n_kv_heads + (bh % H) // (H // n_kv_heads)
        for q0 in range(0, S, BQ):
            kb_hi = -(-kv_len // BK)
            if causal:
                kb_hi = min(kb_hi, (q0 + BQ - 1) // BK + 1)
            kb_lo = 0
            if window and q0 - window - BK + 1 >= 0:
                kb_lo = (q0 - window - BK + 1) // BK + 1
            for w in range(warps):
                rows = w * R + rg[:, None] + RG * i8                 # (32, 8)
                m = torch.full((32, 8), NEG)
                l = torch.zeros((32, 8))
                acc = torch.zeros((32, 8, NC, 4))
                for kb in range(kb_lo, kb_hi):
                    k0 = kb * BK
                    keys = kg[:, None] + KG * j4                     # (32, 4)
                    qa = torch.gather(qp[bh, q0 + rows], 2,
                                      s_cols[:, None].expand(32, 8, -1))
                    ka = torch.gather(kp[kvh, k0 + keys], 2,
                                      s_cols[:, None].expand(32, 4, -1))
                    s = torch.einsum("lid,ljd->lij", qa, ka)
                    # add the ds lanes' partial sums (lane = rg, ds, kg)
                    s = s.reshape(RG, DS, KG, 8, 4).sum(1, keepdim=True)
                    s = s.expand(RG, DS, KG, 8, 4).reshape(32, 8, 4)
                    if softcap:
                        s = softcap * torch.tanh(s / softcap)
                    edge = (k0 + BK > kv_len or (causal and k0 + BK - 1 > q0)
                            or (window and q0 + BQ - 1 - k0 >= window))
                    if edge:
                        qpos = (q0 + rows)[:, :, None]
                        kpos = (k0 + keys)[:, None, :]
                        ok = (kpos < kv_len).expand(32, 8, 4)
                        if causal:
                            ok = ok & (qpos >= kpos)
                        if window:
                            ok = ok & (qpos - kpos < window)
                        s = torch.where(ok, s, torch.tensor(NEG))
                    mx = s.amax(-1).reshape(RG, DS, KG, 8).amax(2, keepdim=True)
                    mx = mx.expand(RG, DS, KG, 8).reshape(32, 8)
                    mn = torch.maximum(m, mx)
                    alpha = torch.exp(m - mn)
                    m = mn
                    p = torch.exp(s - mn[:, :, None])
                    l = l * alpha + p.sum(-1)
                    slice_ = torch.full((BK, R), float("nan"))      # [key][slot]
                    for ln in range(32):
                        for j in range(4):
                            if j % DS == ds[ln]:
                                slice_[kg[ln] + KG * j,
                                       rg[ln] * 8:rg[ln] * 8 + 8] = p[ln, :, j]
                    acc = acc * alpha[:, :, None, None]
                    ckeys = torch.arange(BK // KS) * KS + kq[:, None]   # (32, t)
                    pr = slice_[ckeys[:, :, None], (rg * 8)[:, None, None] + i8]
                    vv = vp[kvh, k0 + ckeys][:, :, o_cols.reshape(32, -1)]
                    vv = torch.stack([vv[ln, :, ln] for ln in range(32)])
                    acc = acc + torch.einsum("lti,ltc->lic", pr, vv).reshape(
                        32, 8, NC, 4)
                l = l.reshape(RG, DS, KG, 8)[:, :1].sum(2, keepdim=True)
                l = l.expand(RG, DS, KG, 8).reshape(32, 8)
                acc = acc.reshape(RG, KS, CG, 8, NC, 4).sum(1, keepdim=True)
                acc = acc.expand(RG, KS, CG, 8, NC, 4).reshape(32, 8, NC, 4)
                for ln in range(32):
                    for i in range(8):
                        if i % KS != kq[ln]:
                            continue
                        cols = o_cols[ln].reshape(-1)
                        keep = cols < hd
                        out[bh, q0 + rows[ln, i], cols[keep]] = (
                            acc[ln, i].reshape(-1)[keep]
                            / torch.clamp(l[ln, i], min=1e-30))
    return out


@pytest.mark.parametrize("B,S,T,H,Hkv,hd,masks", [
    # the shapes of chip_smoke.py's FLASH_CASES, cut to one batch row
    (1, 256, 256, 2, 1, 32, dict(causal=True)),
    (1, 128, 128, 2, 1, 64, dict(causal=True, window=64)),
    (1, 200, 200, 2, 2, 16, dict(causal=True, softcap=50.0)),
    (1, 128, 384, 2, 2, 32, dict(causal=False)),
    (1, 130, 130, 1, 1, 8, dict(causal=True)),
    (1, 256, 256, 4, 2, 16, dict(causal=True, window=100, softcap=30.0)),
    (1, 200, 320, 2, 1, 128, dict(causal=False)),
    (1, 256, 256, 2, 1, 256, dict(causal=True, window=200, softcap=50.0)),
])
def test_flash_f32_lane_layout_equals_the_plain_version(B, S, T, H, Hkv, hd,
                                                        masks):
    rng = np.random.default_rng(hd + S)
    pad = lambda n: -n % FK.BLOCK_Q
    draw = lambda L, heads, scale=1.0: torch.nn.functional.pad(
        torch.from_numpy((rng.standard_normal((B * heads, L, hd)) * scale)
                         .astype(np.float32)), (0, 0, 0, pad(L)))
    q, k, v = draw(S, H, hd ** -0.5), draw(T, Hkv), draw(T, Hkv)
    kw = dict(causal=masks["causal"], window=masks.get("window", 0),
              softcap=masks.get("softcap", 0.0), kv_len=T, n_kv_heads=Hkv)
    got = _f32_kernel_model(q, k, v, **kw)
    want = FK.flash_attention_plain(q, k, v, **kw)
    assert not torch.isnan(got).any()          # every output written
    torch.testing.assert_close(got[:, :S], want[:, :S], rtol=1e-5, atol=1e-5)


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
                                           # dense: 8 chunks, 4 chunks
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
    in rank order. An add round skips each 32-feature block whose staged
    128 value rows are all zero (``!= 0`` false), as each CTA decides from
    the rows it stages."""
    E, F = values.shape
    plan = K.banded_plan(work.shape[0], n_rows, F)
    rows = work.tolist()
    blocks = work[:, 0].contiguous()
    out = torch.empty((n_rows, F))
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
                tile = values[rows[i][1] * 128:(rows[i][1] + 1) * 128]
                fl = ((tile.reshape(128, F // 32, 32) != 0).any(2).any(0)
                      if op == "add" else None)
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
    assert tuple(work.shape) == (sched.work.shape[0], 4)
    if op == "add":
        assert not valp[:, 32:].any()
    want = _run_banded_plain(*call.args, **call.kwargs)
    got = _cluster_walk(work, dstp, valp, R, op, call.kwargs["weights"])
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the dense GAS grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,n_rows,F,cluster", [
    (256, 128, 608, 8),         # one 3-seed serving segment: 8 x 19 = 152 CTAs
    (896, 128, 608, 8),         # one inference chunk's segment: 28 chunks
    (520 * 128, 1024, 608, 8),  # a large stream over eight row blocks
    (128, 128 * 64, 32, 1),     # 4 chunks over 64 row blocks: under one each
    (384, 512, 64, 3),          # 12 chunks over four row blocks
    (0, 128, 32, 1),            # no edge: a cluster of one
    (0, 0, 32, 1),              # no row block at all
])
def test_dense_plan_cluster_size(E, n_rows, F, cluster):
    plan = K.dense_plan(E, n_rows, F)
    assert plan.cluster == cluster
    assert plan.grid == (n_rows // 128 * (F // 32) * cluster, 1)
    assert plan.threads == 256
    assert plan.smem_bytes == K.BANDED_SMEM <= SMEM_LIMIT
    if (E, n_rows, F) == (256, 128, 608):
        assert plan.grid[0] * plan.grid[1] >= 132


WARPS = K.BANDED_THREADS // 32
SLICE = K.EDGE_TILE // WARPS    # positions per warp in the sliced apply


def _sliced_round(acc, rel, contrib, op):
    """One round of the dense kernel's sliced apply (every op but a narrow
    add), warp by warp: warp w reduces positions [16w, 16w + 16) run by
    run; a run inside its slice goes into ``acc`` at once, a first run
    that continues the slice before is left as the slice's leading piece,
    and after the barrier the warp holding a row's first piece folds the
    leading pieces that continue it, in warp order, and writes the row."""
    n = rel.shape[0]
    rows = rel.tolist()
    lead, tails = {}, {}
    for w in range(WARPS):
        a, b = SLICE * w, min(SLICE * w + SLICE, n)
        if a >= b:
            continue
        leading = a > 0 and rows[a] == rows[a - 1]
        row, reg = None, None
        for e in range(a, b):
            if rows[e] != row:
                if row is not None and leading:
                    lead[w], leading = reg, False
                elif row is not None:
                    acc[row] = _combine(op, acc[row], reg)
                row, reg = rows[e], contrib[e]
            else:
                reg = _combine(op, reg, contrib[e])
        if leading:
            lead[w], row = reg, None
        tails[w] = (row, reg)
    for w, (row, reg) in tails.items():
        if row is None:
            continue
        u = w + 1
        while u < WARPS and SLICE * u < n and rows[SLICE * u] == row:
            reg = _combine(op, reg, lead.pop(u))
            if rows[min(SLICE * u + SLICE, n) - 1] != row:
                break
            u += 1
        acc[row] = _combine(op, acc[row], reg)
    assert not lead                 # every leading piece folded once


def _dense_cluster_walk(ids, order, starts, values, n_rows, op, weights):
    """The dense kernel's partition, in PyTorch: per row block, rank r of
    ``dense_plan``'s cluster takes its ``cluster_share`` of the 32-edge
    chunks of the block's run [starts[rb], starts[rb+1]) of the row-sorted
    stream and reduces them, in rounds of up to 128 positions
    (``_sliced_round``), into a partial from the identity, each edge's
    weight and value row read through ``order``; the partials combine in
    rank order."""
    E, F = values.shape
    plan = K.dense_plan(E, n_rows, F)
    out = torch.empty((n_rows, F))
    bounds = starts.tolist()
    for rb in range(n_rows // 128):
        lo, hi = bounds[rb], bounds[rb + 1]
        n_chunks = -(-(hi - lo) // K.CHUNK)
        parts, seen = [], []
        for rank in range(plan.cluster):
            c0, c1 = K.cluster_share(0, n_chunks, rank, plan.cluster)
            p0, p1 = lo + K.CHUNK * c0, min(hi, lo + K.CHUNK * c1)
            acc = torch.full((128, F), _identity(op))
            for p in range(p0, p1, K.EDGE_TILE):
                pos = torch.arange(p, min(p + K.EDGE_TILE, p1))
                seen += pos.tolist()
                rel = ids[pos].long() - rb * 128
                assert ((rel >= 0) & (rel < 128)).all()
                edges = order[pos].long()
                contrib = values[edges]
                if weights is not None:
                    contrib = contrib * weights[edges, None]
                _sliced_round(acc, rel, contrib, op)
            parts.append(acc)
        # every position of the run once, in order
        assert seen == list(range(lo, hi))
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
    "large_sorted",    # 520 edge tiles over eight row blocks, dst ascending
    "large_shuffled",  # the same, dst in no order: every tile in every block
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
    ids, order, starts, valp, R = call.args
    if case.startswith("large"):
        assert valp.shape[0] // 128 >= 512 and R // 128 >= 8
    want = _run_dense_plain(*call.args, **call.kwargs)
    got = _dense_cluster_walk(ids, order, starts, valp, R, op,
                              call.kwargs["weights"])
    if op != "add":
        assert torch.isnan(want).any()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
