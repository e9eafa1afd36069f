#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases, each failing hard (exit status 1, no result line):

1. build both kernel sources (``src/repro_torch/kernels/*/csrc/*.cu``), one
   ``nvcc`` each, started together; print ptxas's registers and spills;
2. hold each FAST-GAS kernel against its plain PyTorch version on the card,
   at the shapes phases 3 and 4 launch (op add with unit and with integer
   weights, with and without all-zero feature blocks; max and min, also
   with NaN values; integer data bit-exact, NaN cells where the plain
   version has them, normal data within rtol = atol = 1e-5; a second
   launch on the same inputs returns the same bits), and the dense grid
   also over 1024 rows and 520 edge tiles with sorted and with shuffled
   dst; print both launch plans (grid, cluster, CTAs, shared bytes; at
   least 132 CTAs on one inference chunk and on one serving segment), and
   time, for add, max and min, the kernel (per call, on the device, and
   the wrapper's host µs per call by piece), the plain version, one
   library call computing the same function (``torch.sparse.mm`` /
   ``scatter_reduce_``, never used by the port) and the memory-bound
   floor. Then the bf16 and f16 instantiations of both kernels: every
   case above on the main path's shapes and four on the dense grid's
   second shape (integer data in [-1, 1] and max / min exact, a repeat
   launch bit-identical, add on normal data within the rounding bound
   2·(γ(3c+2, u) + 2γ(128, 2^-24))·Σ|w·v| per cell that the kernel's
   cluster split and the plain version's per-tile rounding leave, c the
   32-edge chunks holding the cell's row), each op timed as above at
   one inference chunk and at one serving segment. Last, the banded add's
   skip of all-zero feature blocks, which the kernel decides from the rows
   it stages: f32, bf16 and f16 at one inference chunk and over 1024 rows
   and 520 edge tiles, on integer data with all-zero, -0.0 and NaN blocks
   and inf weights, bit for bit with the plain version on every cell that
   is not NaN and NaN on the same cells (``check_skip_inputs``);
3. serving: the GraphSAGE serving engine over a uniform graph of 2^20
   vertices, 16 edges per vertex and Reddit's 602 features, 64 zipf-skewed
   requests of 1–3 seeds from 4 tenants, fan-out 50, ``max_batch=8``, a
   32-row hot cache, once with the banded walk (``scheduled=True``) and once
   on the dense grid (``scheduled=False``); every request is served and
   matches the ``impl="ref"`` engine. Then bf16 and f16 tables of the
   same graph's features rounded to integers in [-2, 2], each on both
   routes with the cache on: rows in the table's dtype, bit for bit with
   its ``impl="ref"`` engine, each launch on its own type's kernel, and
   bf16 cache-on bit for bit with cache-off;
4. inference: ``sage_forward`` at Reddit width (``PALLAS_CONFIG``: F=602,
   H=256, C=41, K1=K2=50, B=64, 16-row command queue, banded walk) on a
   ``GraphBatchStream`` batch; the logits are finite and match
   ``impl="ref"`` within rtol = atol = 1e-4 (the f32 sums run in another
   order through two layers);
5. hold the flash-attention kernel against its plain version on the card:
   the six cases of ``tests/test_kernels_flash.py`` plus hd 128 and 256
   cases, in float32 on the CUDA-core route (rtol = atol = 1e-5) and in
   bfloat16 on the tensor-core route (atol = 2e-2, rtol = 1e-2: p is
   rounded to bf16 before PV in both), each launch on the route its dtype
   names; whisper-base's encoder shape (B·H = 32, S = T = 1536, hd 64,
   kv_len 1500, non-causal) and a gemma2-2b local-layer shape (H 8 / Hkv
   4, hd 256, window 4096, softcap 50, S = T = 4096, causal), each in
   bf16 and in f32; count the tensor-core (HMMA / HGMMA), FFMA and LDS
   instructions in each flash kernel's SASS (``cuobjdump -sass``; the bf16
   kernel must have tensor-core instructions, the f32 kernel none and at
   least 8 FFMA per LDS); time each route's kernel (per call, on the
   device, and the wrapper's host µs per call), the plain version,
   ``scaled_dot_product_attention`` (the library yardstick, never used by
   the port) and the bounds;
6. LM serving: whisper-base at full width (d_model 512, 8 heads, 6 + 6
   layers, vocab 51865, enc_seq 1500, bf16 compute) through
   ``launch.serve``'s LM path: 4 requests of 48 prompt tokens, 24
   generated tokens, weights and frames from a seed. The encoder and the
   decoder's prefill self-attention run on the flash kernel: exactly
   6 + 6 launches per prefill with ``impl="kernel"``,
   all on the route of the compute dtype, none with ``impl="ref"``, and no
   call of the plain version. In float32
   the kernel path matches ``impl="ref"`` on the prefill logits and on 23
   teacher-forced decode steps within rtol = 1e-4, atol = 1e-3; in bf16
   the logits are finite and within 2e-2·max|ref| of ``impl="ref"``;
7. training on phase 3-4's graph at ``PALLAS_CONFIG``: three
   ``make_sage_train_step`` AdamW steps against ``CONFIG``
   (``impl="ref"``) from the same params and batches — each step's loss
   within rtol 1e-4, and, at equal params, both backends' gradients
   within rtol = atol = 1e-4 of max|g| per leaf, outside the weight
   columns of units whose ReLU decision the two f32 summation orders
   flip (counted, at most 8 per step; logged); each step launches
   exactly one inference batch's ``gas_scatter_banded`` and no
   ``gas_scatter_dense``; warm step times and one profiled step. Then the
   feature table's gradient through both GAS backward rules: the
   coalesced fetch (add, unchunked) launches 1 banded + 1 dense per
   forward + backward, 2 kernel scatters counted, the gradient within
   rtol = atol = 1e-5 of ``impl="ref"``, and the dense grid at the
   gather's backward timed beside its bound; max at one chunk's shape
   (integer data) launches the tie count on the banded walk and matches
   ``impl="ref"`` bit for bit.

8. sharded at full width: phase 1's libraries are built before any rank
   starts; then 4 ranks share the card on ``backend="gloo"`` (every
   collective staged through pinned host memory — NCCL refuses two ranks
   on one card — so no time here is an interconnect's), each holding a
   2^18 x 602 interval of phase 3-4's table and 16 of phase 4's 64 seeds
   (the same seeds and samples), at ``PALLAS_CONFIG``. Each rank runs the
   coalesced fetch on integer-valued rows (add and max, cgtrans, and add
   on baseline), ``sage_forward``, three AdamW steps and the 64-request
   serving replay (banded walk, then the dense grid with
   ``scheduled=False``), the same replay and drains on phase 3's bf16
   table, and reports its launch, collective, dispatch and byte counts
   and its results. The fetch is bit for bit the unsharded
   kernel fetch (and baseline bit for bit cgtrans); the logits within
   rtol = atol = 1e-4 of the unsharded kernel logits; each step's loss
   within rtol 1e-4 of the unsharded ``impl="ref"`` step, and at equal
   params the summed gradients held as phase 7 holds them; every serving
   request as phase 3 holds it against the unsharded kernel engine, and
   each bf16 request bit for bit with the unsharded bf16 kernel engine;
   the collectives and dispatches of the fetch (add, max, baseline), the
   forward, each step and each drain (N = 1 and N = 8) equal the contract
   registry's budgets at this full width (``analysis/contracts.py``:
   ``aggregate_multi/*/pallas/sched``, ``sage_forward`` and
   ``train_step/coalesced/pallas/sched`` in two chunked segments,
   ``serving_fetch/fused/pallas`` plus the result gather, and a drain of
   8 dispatching what that contract does), and every path's collective
   and kernel-entry dtypes pass ``analysis/dtype_flow.py`` (the bf16
   table's drains under an explicit ``narrow-wire`` waiver: they ship
   bf16 on ``wire="f32"``, and JAX has no contract for a bf16 table);
   each drain's bytes ``budgets.drain_bytes`` (the bf16 table's partials
   and answers half the f32 table's); the baseline / cgtrans
   bytes above K/4; every path launches its kernel on every rank. Each
   collective wrapper then runs on a 1-rank NCCL group in this process on
   int32 ids and f32 payloads and returns its input. Warm sharded
   forward and step times and the staged collectives' share are printed,
   not gated.

9. full-graph GCN: ``gcn_forward_full`` at ``PALLAS_CONFIG`` (F 602, H
   256, C 41, 2 layers, scheduled) over ``uniform_graph(V=2^18, E=2^22,
   weights=True)``, aggregate add and max: 2 banded launches per forward,
   2 banded + 1 dense per forward + backward (max: + 1 banded tie count);
   logits within rtol = atol = 1e-4 of ``impl="ref"``, the gradient of
   sum(logits · cot) in every parameter within 1e-4 of max|g| per leaf
   outside ReLU-flipped columns (the phase 7 rule, at the ReLU inputs of
   each gradient's own forward) and on every column at the kernel run's
   ReLU decisions. ``aggregate_edges`` on integer data (E·F > 2^31) for
   add, max, min and or, kernel bit for bit with ref; the bf16 and int8
   wires bit-exact no-ops unsharded and ``features="sparse"`` (capacity
   asserted to fit) bit for bit dense on 2^20 of the edges. Then 4 gloo
   ranks share the card at V = 2^14, E = 2^18, F = 602: both dataflows ×
   add and max, cgtrans on the bf16 and int8 wires, baseline on sparse
   features, one ``aggregate_multi`` fetch on the bf16 wire — bit for bit
   with the unsharded port (int8 within 2 % of the span), counts equal to
   the contract registry's (``aggregate_edges/*/pallas``; the narrow
   wires' ``.../xla/{bf16,int8}`` contracts plus the kernel scatter;
   ``aggregate_multi/cgtrans/pallas/bf16``), dtypes clean under each
   contract's waivers, and bytes equal to ``budgets.edges_bytes``. Times:
   warm forwards (kernel and ref), one profiled forward, and the layer-0
   banded launch and the layer-1 gather-backward dense launch (events,
   device, bound, ``torch.sparse.mm``; the banded one's pad copy).

a. islandized partitioning (``partition="island"``), the graph algorithms
   and the cost model. On a community graph with shuffled ids
   (``clustered_graph(V=2^18, E=2^22)``, 64 clusters, ``p_intra`` 0.9,
   F = 602): ``partition_graph(method="island")`` against the interval
   cut (host seconds, remote destination rows at P = 4, live banded and
   dense rounds); ``gcn_forward_full`` under ``ISLAND_PALLAS_CONFIG``
   against ``PALLAS_CONFIG``, add and max — integer data (features and
   params in {-2..2}, unit weights) bit for bit after the un-permute,
   normal data within 1e-4, parameter gradients as phase 9 holds them —
   with the warm forwards and each layout's layer-0 banded launch timed;
   ``sage_forward`` (B = 64; integer data bit for bit, normal within
   1e-5), one ``make_sage_train_step(relabel=)`` step (params within
   1e-5) and ``ServingEngine(partition="island")`` with the hot cache on,
   banded and dense, bit for bit with the interval engine. Then 4 gloo
   ranks at V = 2^14, E = 2^18: ``aggregate_edges`` island ≡ interval bit
   for bit (both dataflows, add / max / min), the island ``sage_forward``
   within 1e-4 of the unsharded port, remote rows and bytes per rank
   printed. Then ``bfs``, ``sssp`` and ``connected_components`` on
   ``rmat(18, 16)`` with ``impl="kernel"`` (one dense launch per round,
   the dispatch counter at JAX's one find and kernel scatter per traversal)
   bit for bit with ``impl="ref"``, ``gas_sort`` of 8192 draws exact,
   ``feature_embedding`` at ``rmat(16, 16)``, F = 602, bit for bit on
   integer data; one round's min scatter and the embedding's add timed
   beside the function's byte bound and the library call
   (``scatter_reduce_`` amin, ``torch.sparse.mm``). Last, the cost
   model's Fig 15 headline.

b. the accounting (phase 1's libraries built first): the card against
   ``common/hw.py``'s H100 spec (132 SMs, "H100" in its name); the
   contract registry (``analysis/contracts.py``, 57 contracts at the JAX
   registry's shapes: part 32, F 64, B 8, K1 3, K2 10, sparse capacity
   16; the three ``embed_lookup`` ones on a 2 × 4 mesh of the same
   ranks) verified on 8 gloo ranks sharing the card with CUDA tensors —
   every contract's collectives, dispatches and dtypes equal to its
   budget forward and forward + backward, and every kernel-route
   contract launching on every rank, in the pass ``kernel_pass`` names,
   the kernel ``kernel_of`` names (banded where the run is scheduled,
   dense otherwise) and not the other; then the 37 counted rows of ``BENCH_collective_bytes.json``
   (``analysis/counted_rows.py``: one spawn of 2, 4 and 8 ranks on the
   card) with zero drift against the committed file, the paper row
   (baseline bytes, cgtrans bytes, ratio) printed.

c. LM training on one card (``phase_lm_train``): ``ops.flash_attention``
   refusing a ``requires_grad`` query before any launch; two f32 steps of
   full-width qwen1.5-0.5b on the card against the CPU; three bf16 steps
   (B 4, S 512, remat ``block``) with no port-kernel launch, timed and
   profiled, their peak memory (``torch.cuda.max_memory_allocated`` after
   a reset) within ±10 % of the dry run's prediction for that step
   (``launch/dryrun.py``'s trace on fake card tensors, which must equal
   the trace on fake CPU tensors); mamba2-780m and recurrentgemma-2b
   served at their published widths; seven architectures at smoke size.

d. the sharded LM: 4 gloo ranks share the card as a (data 2 × model 2)
   ``Mesh`` (``launch/mesh.py``; collectives staged through pinned host
   memory, so no time here is an interconnect's). Full-width
   qwen1.5-0.5b in f32 (24 layers, D 1024, vocab 151,936, tied table;
   each rank draws the full parameters from the seed and keeps its
   blocks), B 4, S 256: the gradients of one ``loss_fn`` (the train
   step's reduction) against the unsharded port on the same card — the
   loss within rtol 1e-5, each leaf within 1e-4 of its max |g| (a key
   bias, whose gradient is zero up to rounding, against the largest
   gradient) — then two ``make_train_step(mesh=)`` steps against two
   unsharded steps (losses within 1e-5, then 1e-4), each rank's step
   times, init and step peak memory (init held to the rank's state
   plus three of the largest full leaf; the step's within ±10 % of the
   dry run's trace of that rank on a ``TraceMesh``), held parameter and
   moment bytes
   and staged
   calls, bytes and seconds printed. bf16 serving of the stepped
   parameters: prefill of 4 × 256 with ``use_flash=True`` (24 flash
   launches per rank, all on ``mma_bf16``, no plain call) and 4
   teacher-forced decode steps within 2e-2 of the largest unsharded
   logit; then, uncounted, ``flash_mma_kernel`` against its plain
   version at each rank's prefill shape (2 rows, 8 heads, S 256, hd 64,
   causal) within the bf16 tolerance of phase 5. ``embed_lookup(impl="kernel")`` at qwen's width (ids 8 × 512)
   counted against the ``embed_lookup/cgtrans/pallas`` contract (and
   ``impl="ref"`` against ``.../xla``), one dense launch per rank per
   gradient, the table gradient bit for bit ``impl="ref"`` on integer
   data and within 1e-5 on normal data. deepseek-moe-16b (experts over
   model) and llama-3.2-vision-90b at smoke size: one sharded step
   against the unsharded port. The tensor-parallel recurrent mixers
   (``ssd`` over its heads, ``rglru`` over its width): mamba2-780m and
   recurrentgemma-2b at their published widths and depths, prefill of 2
   × 256 and 2 teacher-forced decode steps, in f32 (logits within 1e-4
   of the largest unsharded logit) and in bf16 on bf16 copies of the
   parameters with the flash prefill (logits finite, their distance
   printed; recurrentgemma's 8 local layers launch ``flash_mma_kernel``
   on the rank's 5 q heads, one launch each, no plain call); every
   forward's ``psum`` calls those of its layers, each rank's caches the
   bytes the JAX cache schema places on it; then one f32 ``loss_fn``
   gradient check (loss within 1e-5, each leaf within 1e-4 of its max
   |g|) and one ``make_train_step`` step with ``impl="kernel"`` (the
   CGTrans lookup's owner-side gradient on the dense grid: one launch
   per forward + backward for recurrentgemma-2b, none for mamba2-780m's
   baseline lookup), B 4 × S 256, mamba2-780m at full depth and
   recurrentgemma-2b **cut** to one pattern block (rglru, rglru, local:
   f32 AdamW state of 2.7 B parameters beside the unsharded reference's
   does not fit the card), each rank's step peak within ±10 % of the dry
   run's trace; per prefill, decode step and train step the time, the
   staged collectives by name and the collective counts are printed.
   Long-context decode: gemma2-2b at its
   published width and depth (26 layers, local and global, softcaps,
   GQA) in bf16, B 1 under long_500k's rule table
   (``LONG_CONTEXT_RULES``: every rank holds the token) with the JAX
   cache layout (``cache_layout="seq"``: each model rank a 65,536-slot
   slice of every global layer's cache, the 4,096-slot rings on every
   rank), 131,072 slots (**cut** from 524,288: four ranks and the
   unsharded reference share the card); keys and values of positions 0
   … 98,303 drawn from the seed into the unsharded cache, each rank's
   slice taken from the same tensors; 4 teacher-forced steps from
   98,304 and 4 from 4,095 (where model rank 1's slice holds no valid
   position) against the unsharded port, and 4 from 98,304 in the
   other ``"heads"`` layout: bf16 tensor parallelism rounds each row-parallel
   partial product before its psum, which with gemma2's final softcap
   puts both layouts a few per cent of the largest logit off the
   unsharded run, so in bf16 the ``"seq"`` runs are held to 1.5 times
   the ``"heads"`` run's distance; the same two ``"seq"`` runs in f32
   at 32,768 slots (2 steps from 24,576 and 2 from 4,095) within 2e-2
   of the largest unsharded logit. Each rank's ms/step, cache bytes, peak
   memory and staged collectives by name are printed, and the decode's
   collectives counted (per step one q/k/v gather per layer, one
   ``decode_max`` and one ``decode_sum`` per global layer, no row
   gather). Then, in this
   process, the lookup's owner-side dense launch at one rank's shape, at
   qwen's width and at recurrentgemma-2b's, against its plain version
   and timed beside ``index_add_`` and its bytes bound; and
   ``flash_mma_kernel`` at the shape recurrentgemma-2b's local layers
   give it on a rank (1 row, 5 heads, S 256, hd 256, window 2048)
   against its plain version, timed beside SDPA and its bound.

Each kernel's launch count is set to 0 just before each path of phases 3,
4, 6, 7, 8 (in each rank), 9, a, b (in each rank, per contract pass) and
d (in each rank) and read just after; a kernel that a path should launch and did not
fails the run. The last lines are the kernels' JSON, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
``--phases`` runs a subset (for example ``--phases 15`` or
``--phases 1b``); the default runs every phase. Every bound is the
larger of the bytes over the card's HBM rate and the operations over its
peak, from ``common/hw.py``'s H100 spec through
``launch.roofline.roofline_terms``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = {
    "gas_scatter_banded": "src/repro_torch/kernels/gas_scatter/csrc/gas_scatter.cu",
    "gas_scatter_dense": "src/repro_torch/kernels/gas_scatter/csrc/gas_scatter.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
}
REPLACES = {
    "gas_scatter_banded": "src/repro/kernels/gas_scatter/kernel.py:211",
    "gas_scatter_dense": "src/repro/kernels/gas_scatter/kernel.py:266",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:84",
}
# the GAS kernels' bf16 and f16 instantiations, each an entry of its own
NARROW = ("bf16", "f16")
for _base in ("gas_scatter_banded", "gas_scatter_dense"):
    for _sfx in NARROW:
        CSRC[f"{_base}_{_sfx}"] = CSRC[_base]
        REPLACES[f"{_base}_{_sfx}"] = REPLACES[_base]
# phase 6: whisper-base serving, the repo's LM example traffic
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "whisper-base", 4, 48, 24

V, DEGREE, F = 1 << 20, 16, 602
FANOUT, REQUESTS, TENANTS, MAX_BATCH, CACHE = 50, 64, 4, 8, 32
BATCH = 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def add_dtype_launches(launches, counts):
    """Add ``K.dtype_launch_counts()`` to the JSON entries' counts: f32
    under the wrapper's name, a narrow type under ``name_suffix``."""
    for name, by_dtype in counts.items():
        for sfx, n in by_dtype.items():
            launches[name if sfx == "f32" else f"{name}_{sfx}"] += n


def fake_clock(step=1e-4):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def roofline(nbytes, ops, dtype="f32"):
    """(bound_ms, bound_by): the larger of ``nbytes`` over the card's HBM
    rate and ``ops`` over its peak for ``dtype`` (``"f32"`` CUDA cores or
    ``"bf16"`` tensor cores) — ``common/hw.py``'s H100 spec through
    ``launch.roofline.roofline_terms``."""
    from repro_torch.launch.roofline import roofline_terms

    t = roofline_terms(ops, nbytes, dtype=dtype)
    return (max(t.t_memory, t.t_compute) * 1e3,
            "bytes" if t.t_memory >= t.t_compute else "operations")


def event_ms(torch, fn, iters, warm=3):
    """Mean ms per call between CUDA events around ``iters`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters=200, warm=10):
    """Mean host µs per call over ``iters`` back-to-back calls: the time to
    enqueue, not to run (nothing synchronises inside the window)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def wrapper_host_us(torch, K, call):
    """Host µs per call of a GAS wrapper on the card, whole and by piece:
    the output's allocation (``new_empty``, as the wrapper makes it, and
    ``torch.empty``), the stream query (the raw one the wrapper makes, and
    the public ``current_stream``), the ctypes entry alone (its launch
    included; these launches count nowhere) and the rest (the signature
    lookup and the per-call checks)."""
    banded = call.kernel == "gas_scatter_banded"
    if banded:
        meta, dst, vals, R = call.args
        order = None
    else:
        dst, order, meta, vals, R = call.args
    w = call.kwargs.get("weights")
    shape, dev, index = (R, vals.shape[1]), vals.device, vals.get_device()
    # the C entry alone, timed; these launches count nowhere
    fn = K._load()[0 if banded else 1][K.VALUE_DTYPES[vals.dtype]]  # lint: allow(kernel-entry-site): times the C entry alone
    stream = K._load()[2]  # lint: allow(kernel-entry-site): the stream query the wrapper makes
    call.run()  # the signature is checked and cached
    checked = K._SIGNATURES[K._signature("banded" if banded else "dense",
                                         meta, dst, vals, R,
                                         call.kwargs["op"], w, order)]
    out = vals.new_empty(shape)
    pointers = ((meta.data_ptr(), dst.data_ptr()) if banded else
                (dst.data_ptr(), order.data_ptr(), meta.data_ptr()))
    args = (checked.address, *pointers,
            None if w is None else w.data_ptr(), vals.data_ptr(),
            out.data_ptr(), stream(index))
    t = {"call": host_us(torch, call.run),
         "new_empty": host_us(torch, lambda: vals.new_empty(shape)),
         "empty": host_us(torch, lambda: torch.empty(shape, device=dev)),
         "raw_stream": host_us(torch, lambda: stream(index)),
         "current_stream": host_us(
             torch, lambda: torch.cuda.current_stream(dev).cuda_stream),
         "entry": host_us(torch, lambda: fn(*args))}
    t["rest"] = t["call"] - t["new_empty"] - t["raw_stream"] - t["entry"]
    return t


def device_ms(torch, fn, kernel_symbol, iters=50):
    """Mean device time of the kernel named ``kernel_symbol`` per call, from
    the profiler's trace; None when the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_symbol in evt.key:
            total += getattr(evt, "device_time_total", 0.0) or 0.0
            count += evt.count
    if count == 0 or total == 0.0:
        return None
    return total / 1e3 / count


def profile_call(torch, fn, top=8):
    """Profile one call: (profiled wall ms, device kernel ms, top host ops
    as (name, count, self CPU ms), top device kernels as (name, count,
    device ms)). The wall includes the profiler's own overhead, so the
    busy share derived from it is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    device = sum(e.device_time_total for e in avgs
                 if e.device_type == DeviceType.CUDA) / 1e3
    hosts = sorted(avgs, key=lambda e: e.self_cpu_time_total,
                   reverse=True)[:top]
    kernels = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.device_time_total, reverse=True)[:top]
    return (wall, device,
            [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in hosts],
            [(e.key[:60], e.count, e.device_time_total / 1e3)
             for e in kernels])


def device_launches(torch, fn):
    """The device kernels one call of ``fn`` launches, from the
    profiler's trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def bound(call):
    """(bound_ms, bound_by) of a kernel call: the bytes this call's data
    needs (the banded walk: ids and weights of every visited tile, the
    value rows of its live edges in its live feature blocks, the work list;
    the dense grid: the sorted ids, order and weights of its live edges,
    their value rows, ``starts``; the output once; values and output in
    their own type's bytes) over HBM bandwidth, against its f32 operations
    over the f32 peak; the larger wins."""
    import torch

    if call.kernel == "gas_scatter_dense":
        ids, order, starts, vals, R = call.args
        live = int(starts[-1])
        Fp, isz = vals.shape[1], vals.element_size()
        w_bytes = 4 if call.kwargs.get("weights") is not None else 0
        nbytes = (starts.numel() * 4 + live * (8 + w_bytes)
                  + live * Fp * isz + R * Fp * isz)
        return roofline(nbytes, live * Fp * (
            2 if call.kwargs.get("op") == "add" else 1))
    if call.kernel == "gas_scatter_banded_gathered":
        # the value rows are the table's, read through src (4 bytes more
        # an edge)
        work, dst, _, vals, R = call.args
    else:
        work, dst, vals, R = call.args
    rows = work[work[:, 2] == 1]
    rb, tiles = rows[:, 0].long(), rows[:, 1].long()
    if work.shape[1] > 4:
        fl = rows[:, 4:]
    else:
        fl = torch.ones((rows.shape[0], vals.shape[1] // 32),
                        dtype=torch.int32, device=vals.device)
    meta = work.numel() * 4
    E, Fp = vals.shape
    blocks = torch.div(dst.reshape(-1, 128)[tiles], 128, rounding_mode="floor")
    live_edges = (blocks == rb[:, None]).sum(1)     # edges each round reads
    feat_live = fl.sum(1) * 32
    n_tiles = int(tiles.unique().numel())
    id_bytes = n_tiles * 128 * (
        4 + (4 if call.kwargs.get("weights") is not None else 0)
        + (4 if call.kernel == "gas_scatter_banded_gathered" else 0))
    isz = vals.element_size()
    value_bytes = int((live_edges * feat_live).sum()) * isz
    out_bytes = R * Fp * isz
    nbytes = meta + id_bytes + value_bytes + out_bytes
    ops = int((live_edges * feat_live).sum()) * (
        2 if call.kwargs.get("op") == "add" else 1)
    return roofline(nbytes, ops)


def library_fn(torch, call):
    """One PyTorch call computing the same function on the same inputs: a
    sparse (R × E) weight matrix times the values for an f32 add, an
    ``index_add_`` in the values' type for a narrow add (the timed calls
    have unit weights), a ``scatter_reduce_`` for max/min. Built once;
    only the call is timed."""
    dst, vals, R = _call_parts(call)
    op, w = call.kwargs["op"], call.kwargs.get("weights")
    if op == "add" and vals.dtype != torch.float32:
        check(w is None or bool((w[dst < R] == 1).all()),
              "the narrow library add takes unit weights")
        acc = torch.zeros((R + 1, vals.shape[1]), dtype=vals.dtype,
                          device=vals.device)
        ids = dst.long()
        return lambda: acc.index_add_(0, ids, vals)
    if op == "add":
        ok = dst < R
        e = torch.nonzero(ok)[:, 0]
        wv = (w[e] if w is not None
              else torch.ones(e.numel(), device=vals.device))
        A = torch.sparse_coo_tensor(torch.stack([dst[e].long(), e]), wv,
                                    (R, dst.numel()), check_invariants=True
                                    ).coalesce().to_sparse_csr()
        return lambda: torch.sparse.mm(A, vals)
    idx = dst.long()[:, None].expand(-1, vals.shape[1]).contiguous()
    fill = float("-inf") if op == "max" else float("inf")
    out = torch.full((R + 1, vals.shape[1]), fill, dtype=vals.dtype,
                     device=vals.device)
    red = "amax" if op == "max" else "amin"
    return lambda: out.scatter_reduce_(0, idx, vals, red, include_self=True)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def _call_values(torch, rows, data, zero_blocks, dtype=None):
    """``data``: "normal" (the rows as they are), "int" (rounded to
    integers; in [-1, 1] for a narrow ``dtype``, so that every partial sum
    stays an integer the type holds) or "nan" (integers with a NaN in every
    97th edge's every 13th feature); ``zero_blocks`` zeroes features 64-191
    (whole 32-blocks); ``dtype`` casts the result (default: float32)."""
    narrow = dtype not in (None, torch.float32)
    if data in ("int", "nan"):
        rows = torch.round(rows * 4)
        if narrow:
            rows = torch.clamp(rows, -1, 1)
    if data == "nan":
        rows[::97, ::13] = float("nan")
    if zero_blocks:
        rows = rows.clone()
        rows[:, 64:192] = 0.0
    return rows.to(dtype or torch.float32).contiguous()


def _call_weights(torch, op, weights, E, device):
    """Unit weights for add, or (``weights="int"``) integers in [-3, 3]
    made from a seed; None for max and min."""
    import numpy as np

    if op != "add":
        return None
    if weights == "unit":
        return torch.ones(E, device=device)
    return torch.from_numpy(np.random.default_rng(2).integers(
        -3, 4, E).astype(np.float32)).to(device)


def segment_calls(torch, ops, table, nbrs, mask, op, schedule, data,
                  zero_blocks, weights="unit", dtype=None):
    """The kernel call the main path makes for one fan-out segment: the
    (R, K) ids gathered from the table, seed destinations
    ``repeat(arange(R), K)``, unit weights for add (``_call_values`` and
    ``_call_weights`` say what ``data``, ``zero_blocks`` and ``weights``
    change; ``dtype`` is the values' type)."""
    R, K = nbrs.shape
    own = mask & (nbrs >= 0) & (nbrs < table.shape[0])
    rows = table[nbrs.clamp(0, table.shape[0] - 1).reshape(-1).long()]
    seed = torch.arange(R, dtype=torch.int32,
                        device=table.device).repeat_interleave(K)
    sched = (ops.schedule_edges(seed, own.reshape(-1), R, assume_sorted=True)
             if schedule else None)
    return ops.fused_call(seed, _call_values(torch, rows, data, zero_blocks,
                                             dtype),
                          _call_weights(torch, op, weights, R * K,
                                        table.device),
                          own.reshape(-1), R, op=op, schedule=sched)


# the dense grid's second phase-2 shape: many row blocks and edge tiles
MULTI_ROWS, MULTI_TILES = 1024, 520


def multiblock_call(torch, ops, table, op, data, zero_blocks, weights,
                    order, dtype=None):
    """An unscheduled call over MULTI_ROWS rows (8 row blocks) and
    MULTI_TILES edge tiles, table rows at ids from a seed, 90 % of the
    edges live; dst ``sorted`` (each row block occupies ~1/8 of the tiles)
    or ``shuffled`` (each occupies every tile)."""
    import numpy as np

    rng = np.random.default_rng(3)
    E = MULTI_TILES * 128
    dst = rng.integers(0, MULTI_ROWS, E).astype(np.int32)
    if order == "sorted":
        dst = np.sort(dst)
    ids = torch.from_numpy(rng.integers(0, table.shape[0], E)).to(table.device)
    live = torch.from_numpy(rng.random(E) < 0.9).to(table.device)
    rows = _call_values(torch, table[ids], data, zero_blocks, dtype)
    return ops.fused_call(torch.from_numpy(dst).to(table.device), rows,
                          _call_weights(torch, op, weights, E, table.device),
                          live, MULTI_ROWS, op=op)


# (op, data, feature skip, weights) of every phase-2 comparison
CASES = ([("add", data, zb, "unit") for data in ("int", "normal")
          for zb in (False, True)]
         + [("add", data, zb, "int") for data in ("int", "normal")
            for zb in (False, True)]
         + [(op, data, False, None) for op in ("max", "min")
            for data in ("int", "normal", "nan")])


KERNEL_SYMBOL = {"gas_scatter_banded": "banded_cluster_kernel",
                 "gas_scatter_banded_gathered": "banded_cluster_kernel",
                 "gas_scatter_dense": "dense_cluster_kernel"}


def plain_in_order(torch, call):
    """The plain version with PyTorch's deterministic algorithms on: its
    ``index_add_`` then sums each row in index order, not in the order in
    which atomics land, so the comparison with the (deterministic) kernel
    comes out the same in every run."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return call.run_plain()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def check_call(torch, call, label, data):
    """Hold one kernel call against its plain version (``plain_in_order``):
    a second launch bit-identical, identity rows and NaN cells in place,
    integer data bit-exact, normal data within rtol = atol = 1e-5. Returns
    the max abs error on the finite cells."""
    got = call.run()
    again = call.run()
    want = plain_in_order(torch, call)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          f"{label}: two launches on the same inputs differ")
    check(torch.equal(torch.isinf(got), torch.isinf(want)),
          f"{label}: identity rows differ")
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          f"{label}: NaN cells differ")
    check(data != "nan" or bool(torch.isnan(want).any()),
          f"{label}: no NaN reached the output")
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    if data in ("int", "nan"):
        num = ~torch.isnan(want)
        check(torch.equal(got[num], want[num]),
              f"{label}: not bit-exact (err {err})")
    else:
        check(torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5),
              f"{label}: err {err}")
    log(f"  {label}: max_abs_err={err:.3g}, repeat launch bit-identical ok")
    return err


# the narrow types' phase-2 cases on the dense grid's second shape (every
# CASES entry runs on the main path's shapes)
NARROW_MULTI_CASES = [("add", "int", False, "unit"),
                      ("add", "normal", True, "int"),
                      ("max", "normal", False, None),
                      ("min", "nan", False, None)]
# the largest integer each narrow type holds with all below it, and its
# unit roundoff
NARROW_EXACT = {"bf16": 256, "f16": 2048}
UNIT_ROUNDOFF = {"bf16": 2.0 ** -8, "f16": 2.0 ** -11}


def _call_parts(call):
    """(dst in stream order, values, n_rows) of a GAS kernel call (the
    dense grid's from its sorted ids and their order)."""
    if call.kernel == "gas_scatter_banded":
        return call.args[1], call.args[2], call.args[3]
    if call.kernel == "gas_scatter_banded_gathered":
        from repro_torch.kernels.gas_scatter import kernel as K
        _, dst, src, table, R = call.args
        return dst, K.gathered_rows(table, src), R
    ids, order, _, vals, R = call.args
    dst = ids.new_empty(ids.shape)
    dst[order.long()] = ids
    return dst, vals, R


def abs_sums(torch, call):
    """Σ |w·v| per output cell, in f32, through the plain f32 version (the
    weights rounded to the values' type first, as the kernel rounds
    them)."""
    dst, vals, R = _call_parts(call)
    args = list(call.args)
    args[-2] = vals.float().abs().contiguous()
    kw = dict(call.kwargs)
    if kw.get("weights") is not None:
        kw["weights"] = kw["weights"].to(vals.dtype).float().abs()
    return call._replace(args=tuple(args), kwargs=kw).run_plain()


def narrow_add_tolerance(torch, call, name):
    """The per-cell bound on |kernel - plain| of a narrow add on any data
    (the source note of gas_scatter.cu). Both sum the same products, each
    exact in f32, in f32 within a piece of ≤ 128 edges (≤ γ(128, 2^-24)·S
    each), and round to the value type at most 3 times per 32-edge chunk
    holding an edge of the cell's row, plus twice: the plain version twice
    per tile, the kernel twice per piece of a CTA's share and once per
    combine of two partials, so ≤ γ(3c + 2, u)·S each, with S = Σ |w·v|,
    c that chunk count and γ(n, u) = n·u / (1 − n·u). Twice their sum
    bounds the difference."""
    dst, vals, R = _call_parts(call)
    E = dst.numel()
    live = torch.nonzero(dst < R)[:, 0]
    n_chunks = E // 32 + 1
    keys = torch.unique(dst[live].long() * n_chunks + live // 32)
    c = torch.bincount(keys // n_chunks, minlength=R)[:R].double()

    def gamma(n, u):
        nu = n * u
        return torch.where(nu < 1, nu / (1 - nu),
                           torch.full_like(nu, float("inf")))

    u = UNIT_ROUNDOFF[name]
    g = gamma(3 * c + 2, u) + 2 * float(
        gamma(torch.tensor(128.0, dtype=torch.float64), 2.0 ** -24))  # lint: allow(f64-literal): the rounding bound is computed on the host in float64
    S = abs_sums(torch, call).double()
    # a cell with no product must be 0 on both sides (and escapes inf · 0)
    return torch.where(S > 0, 2 * g[:, None] * S, torch.zeros_like(S))


def check_call_narrow(torch, call, label, data, name):
    """Hold one bf16 / f16 kernel call against its plain version
    (``plain_in_order``): a second launch bit-identical, identity rows and
    NaN cells in place, the output in the values' type; integer data (its
    Σ |w·v| within the type's exact integers) and max / min on any data
    exact; add on normal data within ``narrow_add_tolerance``.
    Returns the max abs error on the finite cells."""
    dtype = _call_parts(call)[1].dtype
    got = call.run()
    again = call.run()
    want = plain_in_order(torch, call)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype == dtype, f"{label}: output {got.dtype}")
    check(torch.equal(got.view(torch.int16), again.view(torch.int16)),
          f"{label}: two launches on the same inputs differ")
    check(torch.equal(torch.isinf(got), torch.isinf(want)),
          f"{label}: identity rows differ")
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          f"{label}: NaN cells differ")
    check(data != "nan" or bool(torch.isnan(want).any()),
          f"{label}: no NaN reached the output")
    fin = torch.isfinite(want)
    diff = (got.float() - want.float()).abs()
    err = float(diff[fin].max()) if fin.any() else 0.0
    op = call.kwargs["op"]
    if data in ("int", "nan") or op != "add":
        if op == "add":
            top = float(abs_sums(torch, call).nan_to_num(0.0).max())
            check(top <= NARROW_EXACT[name],
                  f"{label}: partial sums up to {top} leave the exact range")
        # equal values, as the f32 check holds them: a min or max may
        # return either zero of a -0 / +0 pair (integer data rounds to -0)
        num = ~torch.isnan(want)
        check(torch.equal(got[num], want[num]),
              f"{label}: not exact (err {err})")
        log(f"  {label}: exact, repeat launch bit-identical ok")
    else:
        tol = narrow_add_tolerance(torch, call, name)
        check(bool((diff.double() <= tol)[fin].all()),
              f"{label}: err {err} beyond the rounding bound")
        ratio = float((diff.double() / tol.clamp(min=1e-30))[fin].max())
        log(f"  {label}: max_abs_err={err:.3g}, at most {ratio:.3f} of the "
            f"rounding bound 2·(γ(3c+2, u) + 2γ(128, 2^-24))·Σ|w·v|, "
            f"repeat launch bit-identical ok")
    return err


def log_plan(name, plan, call, what):
    ctas = plan.grid[0] * plan.grid[1]
    log(f"  {name} launch at values {tuple(call.args[-2].shape)}"
        f" rows {call.args[-1]} {what}: grid {plan.grid}, cluster "
        f"({plan.cluster}, 1, 1), {ctas} CTAs of {plan.threads} threads, "
        f"{plan.smem_bytes} B shared")
    return ctas


def phase_kernels(torch, ops, K, table, shapes, smi):
    """shapes: {kernel: (nbrs, mask)} from the main path. Returns the JSON
    entries' measured fields per kernel."""
    out = {}
    for name, (nbrs, mask) in shapes.items():
        scheduled = name == "gas_scatter_banded"
        max_err = 0.0
        for op, data, zero_blocks, weights in CASES:
            call = segment_calls(torch, ops, table, nbrs, mask, op,
                                 scheduled, data, zero_blocks, weights)
            check(call.kernel == name, f"{call.kernel} != {name}")
            err = check_call(torch, call, f"{name} op={op} data={data} "
                             f"feature_skip={zero_blocks} weights={weights}",
                             data)
            if data == "normal":
                max_err = max(max_err, err)
        if scheduled:
            work, _, vals, R = call.args
            plan = K.banded_plan(work.shape[0], R, vals.shape[1])
            ctas = log_plan(name, plan, call, f"work {tuple(work.shape)}")
            check(ctas >= 132, f"{name}: only {ctas} CTAs on one chunk")
        else:
            ids, _, starts, vals, R = call.args
            plan = K.dense_plan(ids.shape[0], R, vals.shape[1])
            ctas = log_plan(name, plan, call,
                            f"{int(starts[-1])} live edges")
            check(ctas >= 132, f"{name}: only {ctas} CTAs on one segment")
            # the second shape: many row blocks and edge tiles
            for order in ("sorted", "shuffled"):
                for op, data, zero_blocks, weights in CASES:
                    c = multiblock_call(torch, ops, table, op, data,
                                        zero_blocks, weights, order)
                    check(c.kernel == name, f"{c.kernel} != {name}")
                    err = check_call(
                        torch, c, f"{name} rows {MULTI_ROWS} tiles "
                        f"{MULTI_TILES} dst {order} op={op} data={data} "
                        f"feature_skip={zero_blocks} weights={weights}", data)
                    if data == "normal":
                        max_err = max(max_err, err)
                plan = K.dense_plan(MULTI_TILES * 128, MULTI_ROWS,
                                    c.args[-2].shape[1])
                log_plan(name, plan, c, f"dst {order}")
                t = {"ms": event_ms(torch, c.run, 50),
                     "device_ms": device_ms(torch, c.run, KERNEL_SYMBOL[name],
                                            20)}
                t["bound_ms"], t["bound_by"] = bound(c)
                log(f"  {name} rows {MULTI_ROWS} tiles {MULTI_TILES} dst "
                    f"{order} op={c.kwargs['op']}: {json.dumps(t)}")
        # timings per op, unit weights and normal data, as the main path
        symbol = KERNEL_SYMBOL[name]
        per_op = {}
        for op in ("add", "max", "min"):
            c = segment_calls(torch, ops, table, nbrs, mask, op, scheduled,
                              "normal", False)
            t = {"ms": event_ms(torch, c.run, 200),
                 "host_us": wrapper_host_us(torch, K, c),
                 "device_ms": device_ms(torch, c.run, symbol),
                 "plain_ms": event_ms(torch, c.run_plain, 10),
                 "library_ms": event_ms(torch, library_fn(torch, c), 200)}
            t["bound_ms"], t["bound_by"] = bound(c)
            if op == "add":
                call = c
            per_op[op] = t
            log(f"  {name} op={op} [{smi}]: host {t['host_us']['call']:.2f} "
                f"µs per call, {t['ms']:.4f} ms per call, device "
                f"{t['device_ms']} ms, library {t['library_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.5f} ms; {json.dumps(t)}")
        entry = {"max_abs_err": max_err, **per_op["add"], "ops": per_op}
        work_shape = tuple(call.args[0].shape) if scheduled else None
        log(f"  {name} add+w at values {tuple(call.args[-2].shape)}"
            f" rows {call.args[-1]} work {work_shape}: {json.dumps(entry)}")
        K.reset_launch_counts()
        out[name] = entry
    return out


def phase_kernels_narrow(torch, ops, K, table, shapes, smi):
    """The bf16 and f16 instantiations of both kernels: every CASES entry
    on the main path's shape of each kernel (``shapes``), NARROW_MULTI_CASES
    on the dense grid's second shape, and the timings of each op at both
    main-path shapes (one inference chunk, one serving segment). Returns
    the JSON entries' measured fields per ``kernel_suffix``."""
    out = {}
    both = {"inference_chunk": shapes["gas_scatter_banded"],
            "serving_segment": shapes["gas_scatter_dense"]}
    main = {"gas_scatter_banded": "inference_chunk",
            "gas_scatter_dense": "serving_segment"}
    for sfx, dtype in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        for name, (nbrs, mask) in shapes.items():
            scheduled = name == "gas_scatter_banded"
            entry_name = f"{name}_{sfx}"
            max_err = 0.0
            for op, data, zero_blocks, weights in CASES:
                call = segment_calls(torch, ops, table, nbrs, mask, op,
                                     scheduled, data, zero_blocks, weights,
                                     dtype)
                check(call.kernel == name, f"{call.kernel} != {name}")
                err = check_call_narrow(
                    torch, call, f"{entry_name} op={op} data={data} "
                    f"feature_skip={zero_blocks} weights={weights}", data,
                    sfx)
                if data == "normal":
                    max_err = max(max_err, err)
            if not scheduled:
                for order in ("sorted", "shuffled"):
                    for op, data, zero_blocks, weights in NARROW_MULTI_CASES:
                        c = multiblock_call(torch, ops, table, op, data,
                                            zero_blocks, weights, order,
                                            dtype)
                        err = check_call_narrow(
                            torch, c, f"{entry_name} rows {MULTI_ROWS} tiles "
                            f"{MULTI_TILES} dst {order} op={op} data={data} "
                            f"weights={weights}", data, sfx)
                        if data == "normal":
                            max_err = max(max_err, err)
            # timings per op and shape, unit weights and normal data
            symbol = f"{KERNEL_SYMBOL[name]}<"
            timed = {}
            for shape_name, (sn, sm) in both.items():
                per_op = {}
                for op in ("add", "max", "min"):
                    c = segment_calls(torch, ops, table, sn, sm, op,
                                      scheduled, "normal", False,
                                      dtype=dtype)
                    t = {"ms": event_ms(torch, c.run, 200),
                         "host_us": wrapper_host_us(torch, K, c),
                         "device_ms": device_ms(torch, c.run, symbol),
                         "plain_ms": event_ms(torch, c.run_plain, 10),
                         "library_ms": event_ms(torch, library_fn(torch, c),
                                                200)}
                    t["bound_ms"], t["bound_by"] = bound(c)
                    per_op[op] = t
                    log(f"  {entry_name} {shape_name} values "
                        f"{tuple(_call_parts(c)[1].shape)} op={op} [{smi}]: "
                        f"host {t['host_us']['call']:.2f} µs per call, "
                        f"{t['ms']:.4f} ms per call, device "
                        f"{t['device_ms']} ms, library "
                        f"{t['library_ms']:.4f} ms, bound "
                        f"{t['bound_ms']:.5f} ms; {json.dumps(t)}")
                timed[shape_name] = per_op
            entry = {"max_abs_err": max_err, **timed[main[name]]["add"],
                     "shapes": timed}
            K.reset_launch_counts()
            out[entry_name] = entry
    return out


def plant_skip_blocks(torch, rows, weights, live):
    """In every other 128-edge tile of ``rows`` (E, F): features 32-63
    all zero, 64-95 all -0.0 (both skipped by a banded add), 96-127 zero
    but for one NaN (applied), on the tile's first live edge, which also
    takes weight inf. Returns the planted rows and weights and those
    edges."""
    rows, weights = rows.clone(), weights.clone()
    edges = []
    for t0 in range(0, rows.shape[0], 2 * 128):
        sl = slice(t0, t0 + 128)
        rows[sl, 32:64] = 0.0
        rows[sl, 64:96] = -0.0
        rows[sl, 96:128] = 0.0
        own = torch.nonzero(live[sl])[:, 0]
        if own.numel():
            e = t0 + int(own[0])
            rows[e, 100] = float("nan")
            weights[e] = float("inf")
            edges.append(e)
    return rows, weights, edges


def check_skip_inputs(torch, ops, table, chunk):
    """Hold the banded walk's skip of all-zero feature blocks against its
    plain version for f32, bf16 and f16, on one inference chunk and on a
    scheduled call over MULTI_ROWS rows and MULTI_TILES edge tiles (sorted
    dst: a work list past one window): integer values (``_call_values``)
    and weights with ``plant_skip_blocks``' blocks. Bit for bit on every
    cell the plain version leaves a number, NaN on the same cells, and a
    repeat launch bit-identical; the row of each inf edge finite in the
    skipped blocks and NaN at its NaN."""
    import numpy as np

    nbrs, mask = chunk
    R, K_ = nbrs.shape
    own = (mask & (nbrs >= 0) & (nbrs < table.shape[0])).reshape(-1)
    rng = np.random.default_rng(5)
    E = MULTI_TILES * 128
    multi_dst = torch.from_numpy(np.sort(rng.integers(
        0, MULTI_ROWS, E)).astype(np.int32)).to(table.device)
    inputs = {
        "inference chunk": (
            torch.arange(R, dtype=torch.int32,
                         device=table.device).repeat_interleave(K_),
            own, table[nbrs.clamp(0, table.shape[0] - 1).reshape(-1).long()],
            R),
        f"rows {MULTI_ROWS} tiles {MULTI_TILES}": (
            multi_dst, torch.from_numpy(rng.random(E) < 0.9).to(table.device),
            table[torch.from_numpy(rng.integers(0, table.shape[0], E)).to(
                table.device)], MULTI_ROWS)}
    for name, (dst, live, rows, n_rows) in inputs.items():
        sched = ops.schedule_edges(dst, live, n_rows)
        p = sched.perm.long()
        dst, live, rows = dst[p], live[p], rows[p]
        for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                           ("f16", torch.float16)):
            vals, w, edges = plant_skip_blocks(
                torch, _call_values(torch, rows, "int", False, dtype),
                _call_weights(torch, "add", "int", dst.numel(), dst.device),
                live)
            call = ops.fused_call(dst, vals, w, live, n_rows, op="add",
                                  schedule=sched)
            label = f"gas_scatter_banded_{sfx} skip input, {name}"
            check(call.kernel == "gas_scatter_banded" and
                  tuple(call.args[0].shape) == (sched.work.shape[0], 4),
                  f"{label}: not the schedule's (W, 4) work list")
            bits = torch.int32 if sfx == "f32" else torch.int16
            got = call.run()
            again = call.run()
            want = plain_in_order(torch, call)
            torch.cuda.synchronize()
            check(torch.equal(got.view(bits), again.view(bits)),
                  f"{label}: two launches on the same inputs differ")
            nan = torch.isnan(want)
            check(torch.equal(torch.isnan(got), nan),
                  f"{label}: NaN cells differ")
            check(torch.equal(got.view(bits)[~nan], want.view(bits)[~nan]),
                  f"{label}: not bit for bit")
            rows_hit = dst[edges].long()
            check(len(edges) > 0 and
                  bool(torch.isfinite(got[rows_hit, 32:96]).all()) and
                  bool(torch.isnan(got[rows_hit, 100]).all()),
                  f"{label}: a skipped block is not finite at an inf "
                  f"weight, or the NaN block was skipped")
            log(f"  {label}: {len(edges)} inf edges, {int(nan.sum())} NaN "
                f"cells; bit for bit, repeat launch bit-identical ok")


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def serve(ServingEngine, replay_traffic, feats, indptr, indices, cache=CACHE,
          **kw):
    eng = ServingEngine(feats, indptr, indices, fanout=FANOUT,
                        max_batch=MAX_BATCH, cache_capacity=cache,
                        clock=fake_clock(), sample_seed=0, device="cuda",
                        **kw)
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, per_tenant = replay_traffic(eng, requests=REQUESTS,
                                      tenants=TENANTS, seed=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results = {r: eng.result(r) for r in rids}
    check(eng.stats["queries"] == REQUESTS and len(results) == REQUESTS,
          f"served {eng.stats['queries']}/{REQUESTS}")
    snap = eng.health_snapshot()
    log(f"  impl={eng.impl} scheduled={kw.get('scheduled')} table "
        f"{eng.feats.dtype}: served "
        f"{eng.stats['queries']}/{REQUESTS} in {dt * 1e3:.1f} ms over "
        f"{eng.stats['command_blocks']} command blocks, tenants {per_tenant},"
        f" stats {eng.stats}, cache hit rate "
        f"{snap.get('cache', {}).get('hit_rate', 0.0):.3f}")
    del eng
    torch.cuda.empty_cache()
    return results


def compare_serving(ref, got, label, against="impl=ref"):
    err = 0.0
    for rid, a in ref.items():
        b = got[rid]
        check(a.tenant == b.tenant, f"{label}: tenant of {rid}")
        check((a.self_rows == b.self_rows).all(), f"{label}: self rows {rid}")
        check((a.from_cache == b.from_cache).all(), f"{label}: cache {rid}")
        check(b.agg_rows.shape == a.agg_rows.shape, f"{label}: shape {rid}")
        d = float(abs(a.agg_rows - b.agg_rows).max())
        check(d <= 1e-5 + 1e-5 * float(abs(a.agg_rows).max()),
              f"{label}: agg rows of {rid} off by {d}")
        err = max(err, d)
    log(f"  {label}: all {len(ref)} results match {against} "
        f"(max |agg diff| {err:.3g})")


def rows_equal(a, b):
    """Two result row blocks with the same dtype and bits (numpy arrays,
    or ``torch.bfloat16`` tensors for a bf16 table)."""
    import torch

    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a.view(torch.int16), b.view(torch.int16)))
    return (not torch.is_tensor(b) and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def compare_serving_exact(ref, got, label, dtype, against="impl=ref"):
    """Every request's rows bit for bit, in the table's dtype."""
    for rid, a in ref.items():
        b = got[rid]
        check(a.tenant == b.tenant, f"{label}: tenant of {rid}")
        check(b.self_rows.dtype == b.agg_rows.dtype == dtype,
              f"{label}: rows of {rid} in {b.self_rows.dtype}")
        check(rows_equal(a.self_rows, b.self_rows),
              f"{label}: self rows {rid}")
        check(rows_equal(a.agg_rows, b.agg_rows), f"{label}: agg rows {rid}")
    log(f"  {label}: all {len(ref)} results bit for bit with {against}, in "
        f"{dtype}")


def narrow_tables(torch, features):
    """Phase 3's bf16 and f16 tables: the graph's features rounded to
    integers in [-2, 2] (every fan-out sum an integer within 100, so each
    type holds it exactly) on the host. Adding 0.0 turns the -0.0 that
    rounding gives small negatives into 0.0: a sharded fetch sums a row's
    shard partials, which maps -0.0 to +0.0, so bits would differ where
    values agree."""
    import numpy as np

    ints = torch.from_numpy(np.clip(np.round(features * 2), -2, 2) + 0.0)
    return {"bf16": ints.to(torch.bfloat16), "f16": ints.to(torch.float16)}


# ---------------------------------------------------------------------------
# phase 5: the flash kernel against its plain version
# ---------------------------------------------------------------------------

# the six cases of tests/test_kernels_flash.py, then hd 128 and 256 (every
# head-dim instance of both routes): (B, S, T, H, Hkv, hd, masks)
FLASH_CASES = [
    (1, 256, 256, 4, 2, 32, dict(causal=True)),
    (2, 128, 128, 2, 1, 64, dict(causal=True, window=64)),
    (1, 200, 200, 4, 4, 16, dict(causal=True, softcap=50.0)),
    (1, 128, 384, 2, 2, 32, dict(causal=False)),
    (1, 130, 130, 2, 2, 8, dict(causal=True)),
    (1, 256, 256, 8, 2, 16, dict(causal=True, window=100, softcap=30.0)),
    (1, 200, 320, 2, 1, 128, dict(causal=False)),
    (1, 512, 512, 2, 1, 256, dict(causal=True, window=200, softcap=50.0)),
]
FLASH_SYMBOL = {"mma_bf16": "flash_mma_kernel", "fma_f32": "flash_fwd_kernel"}
FLASH_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=1e-2, atol=2e-2)}


def flash_inputs(torch, FK, B, S, T, H, Hkv, hd, dtype, seed):
    """Kernel arguments as ``ops.flash_attention`` builds them: heads
    flattened, S and T padded to 128; q pre-scaled by hd^-0.5."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pad = lambda n: -n % FK.BLOCK_Q

    def draw(L, heads, scale=1.0):
        x = torch.randn((B * heads, L, hd), generator=g, device="cuda") * scale
        return torch.nn.functional.pad(x, (0, 0, 0, pad(L))).to(dtype)

    return (draw(S, H, hd ** -0.5), draw(T, Hkv), draw(T, Hkv))


def flash_bound(S, T, H, Hkv, B, hd, kw, itemsize):
    """(bound_ms, bound_by, f32 CUDA-core ms, operations): 4·hd operations
    per visible (query, key) pair over the bf16 tensor-core peak, against
    q, k, v and out (as padded for the kernel) read or written once over
    HBM; and the same operations over the f32 peak alone."""
    import numpy as np

    qpos = np.arange(S)[:, None]
    kpos = np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if kw.get("causal"):
        ok &= qpos >= kpos
    if kw.get("window"):
        ok &= qpos - kpos < kw["window"]
    ops = 4 * hd * int(ok.sum()) * B * H
    Sp, Tp = -(-S // 128) * 128, -(-T // 128) * 128
    nbytes = itemsize * hd * (2 * B * H * Sp + 2 * B * Hkv * Tp)
    return (*roofline(nbytes, ops, "bf16"), roofline(0, ops)[0], ops)


SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(lib):
    """{kernel function: {"tensor": HMMA / HGMMA, "ffma": FFMA, "lds": LDS
    instructions}} in a built library's SASS, from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
    counts, fn = {}, None
    kinds = {"HMMA": "tensor", "HGMMA": "tensor", "FFMA": "ffma", "LDS": "lds"}
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"tensor": 0, "ffma": 0, "lds": 0}
            continue
        op = SASS_OP.search(line)
        if fn is not None and op:
            kind = kinds.get(op.group(1).split(".")[0])
            if kind:
                counts[fn][kind] += 1
    return counts


def phase_flash(torch, FK, smi):
    """Returns the JSON fields measured at whisper-base's encoder shape."""
    import torch.nn.functional as Fn

    sass = sass_counts(FK.build())
    for fn, n in sass.items():
        log(f"  SASS {fn}: {n['tensor']} HMMA/HGMMA, {n['ffma']} FFMA, "
            f"{n['lds']} LDS")
    for route, symbol in FLASH_SYMBOL.items():
        n = {kind: sum(c[kind] for f, c in sass.items() if symbol in f)
             for kind in ("tensor", "ffma", "lds")}
        ratio = n["ffma"] / max(n["lds"], 1)
        log(f"  route {route} ({symbol}): {n['tensor']} tensor-core "
            f"instructions, {n['ffma']} FFMA / {n['lds']} LDS = {ratio:.2f}")
        check(route != "mma_bf16" or n["tensor"] > 0,
              f"{symbol} has no tensor-core instruction in its SASS")
        if route == "fma_f32":
            # each shared load feeds at least 8 FFMA (the design's floor)
            check(n["tensor"] == 0 and ratio >= 8,
                  f"{symbol}: {n['tensor']} tensor-core instructions, "
                  f"FFMA/LDS {ratio:.2f} < 8")
            f32_sass = dict(n, ffma_per_lds=ratio)

    def compare(label, args, kw, dtype, n_rows):
        FK.reset_launch_counts()
        got = FK.flash_attention_fwd(*args, **kw)
        route = FK.ROUTES[args[0].dtype]
        check(FK.route_launch_counts()[route] == 1,
              f"{label}: not launched on route {route} "
              f"({FK.route_launch_counts()})")
        want = FK.flash_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        got, want = got[:, :n_rows].float(), want[:, :n_rows].float()
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, **FLASH_TOL[dtype]),
              f"{label}: max_abs_err {err}")
        log(f"  {label} [{route}]: max_abs_err={err:.3g} ok")
        return err

    for i, (B, S, T, H, Hkv, hd, masks) in enumerate(FLASH_CASES):
        for dtype in ("float32", "bfloat16"):
            args = flash_inputs(torch, FK, B, S, T, H, Hkv, hd,
                                getattr(torch, dtype), seed=i)
            kw = dict(causal=masks["causal"], window=masks.get("window", 0),
                      softcap=masks.get("softcap", 0.0), kv_len=T,
                      n_kv_heads=Hkv)
            compare(f"case{i} B={B} S={S} T={T} H={H}/{Hkv} hd={hd} {masks}"
                    f" {dtype}", args, kw, dtype, S)

    shapes = {
        # whisper-base's encoder self-attention: 4 requests x 8 heads
        "whisper-base encoder": (4, 1500, 1500, 8, 8, 64,
                                 dict(causal=False)),
        # gemma2-2b's local layer at a 4096-token prefill
        "gemma2-2b local": (1, 4096, 4096, 8, 4, 256,
                            dict(causal=True, window=4096, softcap=50.0)),
    }
    out, entries = {}, {}
    for name, (B, S, T, H, Hkv, hd, masks) in shapes.items():
        args = flash_inputs(torch, FK, B, S, T, H, Hkv, hd, torch.bfloat16,
                            seed=7)
        kw = dict(causal=masks["causal"], window=masks.get("window", 0),
                  softcap=masks.get("softcap", 0.0), kv_len=T, n_kv_heads=Hkv)
        err = compare(f"{name} B·H={B * H} S=T={args[0].shape[1]} hd={hd} "
                      f"kv_len={T} {masks} bfloat16", args, kw, "bfloat16", S)
        run = lambda: FK.flash_attention_fwd(*args, **kw)
        slow = S >= 4096
        ms = event_ms(torch, run, 5 if slow else 20)
        dev_ms = device_ms(torch, run, FLASH_SYMBOL["mma_bf16"],
                           5 if slow else 20)
        plain_ms = event_ms(torch, lambda: FK.flash_attention_plain(*args, **kw),
                            2, warm=1)
        # the library yardstick on the unpadded (B, H, S, hd) layout, kv
        # heads repeated to H; it has no softcap, so at gemma2's shape it
        # computes a nearby function
        lq = args[0][:, :S].reshape(B, H, S, hd).contiguous()
        lk, lv = (t[:, :T].reshape(B, Hkv, T, hd)
                  .repeat_interleave(H // Hkv, dim=1).contiguous()
                  for t in args[1:])
        lib_ms = event_ms(torch, lambda: Fn.scaled_dot_product_attention(
            lq, lk, lv, is_causal=masks["causal"], scale=1.0),
            5 if slow else 20)
        bound_ms, bound_by, f32_ms, n_ops = flash_bound(S, T, H, Hkv, B, hd,
                                                        masks, 2)
        entry = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                 "host_us": host_us(torch, run, 50 if slow else 200),
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "bound_f32_cuda_core_ms": f32_ms,
                 "tflops": n_ops / ms / 1e9}
        # the float32 route (the CUDA-core kernel) on the same values, held
        # against its plain version; SDPA f32 beside it (at gemma2's shape
        # without the softcap, so a nearby function)
        a32 = tuple(t.float() for t in args)
        run32 = lambda: FK.flash_attention_fwd(*a32, **kw)
        l32 = tuple(t.float() for t in (lq, lk, lv))
        entry["f32_route_max_abs_err"] = compare(
            f"{name} B·H={B * H} S=T={args[0].shape[1]} hd={hd} kv_len={T} "
            f"{masks} float32", a32, kw, "float32", S)
        entry["f32_route_ms"] = event_ms(torch, run32, 5 if slow else 20)
        entry["f32_route_device_ms"] = device_ms(
            torch, run32, FLASH_SYMBOL["fma_f32"], 5 if slow else 20)
        entry["f32_route_host_us"] = host_us(torch, run32,
                                             50 if slow else 200)
        entry["f32_route_plain_ms"] = event_ms(
            torch, lambda: FK.flash_attention_plain(*a32, **kw), 2, warm=1)
        entry["f32_route_library_ms"] = event_ms(
            torch, lambda: Fn.scaled_dot_product_attention(
                *l32, is_causal=masks["causal"], scale=1.0),
            5 if slow else 20)
        entry["f32_route_bound_ms"] = f32_ms
        d32 = entry["f32_route_device_ms"]
        entry["f32_route_bound_share"] = f32_ms / d32 if d32 else None
        log(f"  {name} [{smi}]: {json.dumps(entry)}")
        entries[name] = entry
        FK.reset_launch_counts()
    out["flash_attention"] = dict(entries["whisper-base encoder"],
                                  f32_route_sass=f32_sass,
                                  gemma2_local=entries["gemma2-2b local"])
    return out


# ---------------------------------------------------------------------------
# phase 6: whisper-base serving at full width
# ---------------------------------------------------------------------------

def flash_layers(cfg):
    """Flash launches in one prefill with ``use_flash``: every encoder layer
    and every decoder layer's self-attention."""
    return cfg.n_enc_layers + sum(k in ("attn", "local", "moe", "dec")
                                  for k in cfg.layer_kinds())


def phase_lm(torch, FK, smi):
    """Returns the flash kernel's launches on the counted main-path run,
    all and per route."""
    from repro_torch import configs
    from repro_torch.common.schema import count_params, init_params
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    cfg = configs.get_config(LM_ARCH)
    argv = ["--workload", "lm", "--arch", LM_ARCH, "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN)]
    FK.reset_launch_counts()
    check(serve.main(argv) == 0, f"serve.main({argv}) failed")
    launches = FK.launch_counts()["flash_attention"]
    routes = FK.route_launch_counts()
    plain = FK.flash_attention_plain.calls
    log(f"  launch.serve {' '.join(argv)}: {launches} flash launches "
        f"{routes}, {plain} plain calls")
    main_route = FK.ROUTES[getattr(torch, cfg.compute_dtype)]
    check(routes[main_route] == launches,
          f"the {cfg.compute_dtype} prefill left route {main_route}: {routes}")
    check(launches == flash_layers(cfg),
          f"the prefill launched flash {launches} times, expected "
          f"{flash_layers(cfg)}")
    check(plain == 0, f"the card path called the plain version {plain} times")

    schema = T.model_schema(cfg, max_seq=LM_PROMPT + LM_GEN)
    params = init_params(schema, 0, device="cuda")
    batch = serve.lm_batch(cfg, LM_BATCH, LM_PROMPT, seed=0)
    log(f"  {LM_ARCH}: {count_params(schema) / 1e6:.2f} M params, "
        f"{LM_BATCH} x {LM_PROMPT} prompt, {LM_GEN} generated, enc_seq "
        f"{cfg.enc_seq}")

    def run(c, impl, forced=None):
        FK.reset_launch_counts()
        out = serve.generate(params, batch, c, gen=LM_GEN,
                             use_flash=impl == "kernel", forced=forced)
        n = FK.launch_counts()["flash_attention"]
        want = flash_layers(c) if impl == "kernel" else 0
        check(n == want, f"{c.compute_dtype} impl={impl}: {n} flash launches,"
              f" expected {want}")
        route = FK.ROUTES[getattr(torch, c.compute_dtype)]
        check(FK.route_launch_counts()[route] == n,
              f"{c.compute_dtype} impl={impl}: launches off route {route}: "
              f"{FK.route_launch_counts()}")
        check(FK.flash_attention_plain.calls == 0,
              "the card path called the plain flash version")
        for lg in out["logits"]:
            check(tuple(lg.shape) == (LM_BATCH, cfg.vocab_padded),
                  f"logits shape {tuple(lg.shape)}")
            check(bool(torch.isfinite(lg[:, :cfg.vocab]).all()),
                  f"{c.compute_dtype} impl={impl}: non-finite logits")
        steps = LM_GEN - 1
        log(f"  {c.compute_dtype} impl={impl}: {n} flash launches on "
            f"{route if n else 'no route'}; prefill "
            f"{out['prefill_s'] * 1e3:.2f} ms, decode "
            f"{out['decode_s'] * 1e3 / steps:.3f} ms/step, "
            f"{LM_BATCH * steps / out['decode_s']:.1f} tok/s [{smi}]")
        return out

    # float32: kernel vs ref on the prefill and 23 teacher-forced steps
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    k32 = run(c32, "kernel")
    r32 = run(c32, "ref", forced=k32["tokens"])
    err = 0.0
    for i, (a, b) in enumerate(zip(k32["logits"], r32["logits"])):
        a, b = a[:, :cfg.vocab], b[:, :cfg.vocab]
        d = float((a - b).abs().max())
        err = max(err, d)
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-3),
              f"float32 {'prefill' if i == 0 else f'decode step {i}'} logits "
              f"off impl=ref by {d}")
    log(f"  float32: prefill + {LM_GEN - 1} teacher-forced decode logits "
        f"match impl=ref, max |diff| {err:.3g} (logits up to "
        f"{float(r32['logits'][0][:, :cfg.vocab].abs().max()):.1f})")

    # bfloat16, the published compute dtype
    kb = run(cfg, "kernel")
    rb = run(cfg, "ref")
    a, b = kb["logits"][0][:, :cfg.vocab], rb["logits"][0][:, :cfg.vocab]
    scale = float(b.abs().max())
    d = float((a - b).abs().max())
    check(d <= 2e-2 * scale, f"bfloat16 prefill logits off impl=ref by {d} "
          f"(limit {2e-2 * scale:.3g})")
    agree = float((kb["tokens"] == rb["tokens"]).float().mean())
    log(f"  bfloat16: prefill logits max |kernel - ref| {d:.3g} of "
        f"{scale:.1f}; greedy tokens agree {100 * agree:.1f}%")

    # warm bf16 timings on the host clock, in turns
    timed = {"kernel": [], "ref": []}
    for impl in ("kernel", "ref", "ref", "kernel"):
        timed[impl].append(serve.generate(params, batch, cfg, gen=LM_GEN,
                                          use_flash=impl == "kernel"))
    steps = LM_GEN - 1
    for impl, outs in timed.items():
        log(f"  warm bf16 impl={impl} [{smi}]: prefill "
            + ", ".join(f"{o['prefill_s'] * 1e3:.2f}" for o in outs)
            + " ms; decode "
            + ", ".join(f"{o['decode_s'] * 1e3 / steps:.3f}" for o in outs)
            + " ms/step; "
            + ", ".join(f"{LM_BATCH * steps / o['decode_s']:.1f}"
                        for o in outs) + " tok/s")

    from repro_torch.train import make_prefill_step
    pre = make_prefill_step(cfg, cache_len=LM_PROMPT + LM_GEN,
                            use_flash=True)
    pre32 = make_prefill_step(c32, cache_len=LM_PROMPT + LM_GEN,
                              use_flash=True)
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    profile_call(torch, lambda: pre(params, tb))  # the profiler's own set-up
    pre32(params, tb)
    for label, fn in (
            ("one warm bf16 kernel prefill", lambda: pre(params, tb)),
            ("one warm f32 kernel prefill", lambda: pre32(params, tb)),
            (f"one warm bf16 kernel request (prefill + {steps} steps)",
             lambda: serve.generate(params, batch, cfg, gen=LM_GEN,
                                    use_flash=True))):
        wall, device, hosts, kernels = profile_call(torch, fn)
        log(f"  profile of {label} (profiler on): wall {wall:.1f} ms, "
            f"device time {device:.2f} ms ({100 * device / wall:.1f}% busy);"
            " top host ops (self CPU ms): "
            + "; ".join(f"{k} x{n} {ms:.1f}" for k, n, ms in hosts)
            + "; top device kernels (ms): "
            + "; ".join(f"{k} x{n} {ms:.2f}" for k, n, ms in kernels))
    return launches, routes


# ---------------------------------------------------------------------------
# phase c: LM training on one card; the recurrent, MoE and cross kinds
# ---------------------------------------------------------------------------

LM_TRAIN_ARCH = "qwen1.5-0.5b"
# the card against the CPU: f32, B = 1, S = 128, two steps; at eps 1e-3
# AdamW's first steps move each parameter as a smooth function of its
# gradient (tests/_lm_parity.py says why the default eps does not)
PARITY_B, PARITY_S, PARITY_STEPS = 1, 128, 2
PARITY_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                 eps=1e-3)
# the bf16 run on the card: B = 4, S = 512, three steps on TokenStream(0)
BF16_B, BF16_S, BF16_STEPS = 4, 512, 3
# the recurrent kinds, served at their published widths, and one train step
RECURRENT_ARCHS = ("mamba2-780m", "recurrentgemma-2b")
SSD_TRAIN_B, SSD_TRAIN_S = 2, 256
# every architecture the kinds added, at smoke size: card against the CPU
NEW_ARCHS = ("gemma3-12b", "phi3-medium-14b", "deepseek-moe-16b",
             "moonshot-v1-16b-a3b", "llama-3.2-vision-90b", "mamba2-780m",
             "recurrentgemma-2b")
SMOKE_B, SMOKE_P, SMOKE_STEPS = 2, 8, 4
SMOKE_KW = dict(learning_rate=1e-2, warmup_steps=1, total_steps=5, eps=1e-3)
# a step's measured peak memory against the dry run's prediction
# (launch/dryrun.py, traced on fake tensors): within this share either way
PEAK_TOL = 0.10


def dry_run_memory(cfg, shape, mesh, tc, device=None):
    """The dry run's trace of one rank's step (``mesh=None``: unsharded):
    its ``memory`` record, ``dot_flops`` and the seconds it took."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rec = dryrun.trace_cell(cfg, shape, mesh, tc, device=device)
    return {**rec["memory"], "dot_flops": rec["roofline"]["flops"],
            "fake_device": rec["fake_device"],
            "trace_s": time.perf_counter() - t0}


def hold_peak(label, peak, base, pred, smi):
    """Hold a step's measured peak (``max_memory_allocated`` since a reset
    at which ``base`` bytes were allocated, the step's arguments among
    them) against the dry run: the base plus what the traced step holds
    beyond its arguments."""
    extra = pred["peak_bytes_per_device"] - pred["traced_args_bytes"]
    want = base + extra
    ratio = peak / want
    check(abs(ratio - 1) <= PEAK_TOL,
          f"{label}: peak memory {peak} B on the card, the dry run "
          f"predicts {want} B (ratio {ratio:.4f}, limit 1 ± {PEAK_TOL})")
    log(f"  {label} [{smi}]: peak memory {peak / 2**30:.4f} GiB measured "
        f"(torch.cuda.max_memory_allocated), {want / 2**30:.4f} GiB "
        f"predicted by the dry run ({base / 2**30:.4f} GiB allocated at "
        f"the reset + {extra / 2**30:.4f} GiB the traced step holds beyond "
        f"its arguments; fake {pred['fake_device']} tensors, traced in "
        f"{pred['trace_s']:.1f} s): ratio {ratio:.4f}")
    return ratio


def _tree_to(tree, device):
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _tree_clone(tree):
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


def _tree_max_diff(a, b):
    """max |a - b| over two trees of tensors (b's leaves moved to a's
    device)."""
    from repro_torch.common.tree import leaves
    return max(float((x.float() - y.to(x.device).float()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def _close(a, b, rtol, atol):
    """(every element within atol + rtol·|b|, max |a - b|)."""
    b = b.to(a.device)
    d = (a - b).abs()
    return bool((d <= atol + rtol * b.abs()).all()), float(d.max())


def flash_refusal_on_card(torch, FK):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    q = torch.randn(1, 128, 2, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device="cuda")
    FK.reset_launch_counts()
    try:
        flash_ops.flash_attention(q, k, k)
        refused = False
    except NotImplementedError as exc:
        refused = "no VJP" in str(exc)
    n = FK.launch_counts()["flash_attention"]
    check(refused, "flash_attention took a requires_grad q on the card")
    check(n == 0 and FK.flash_attention_plain.calls == 0,
          f"the refusal launched: {n} launches, "
          f"{FK.flash_attention_plain.calls} plain calls")
    log("  flash_attention refuses a requires_grad q on the card before any "
        "launch (0 launches, 0 plain calls)")


def qwen_parity(torch, cfg):
    """Two f32 steps at full width on the card and on the CPU from the
    same parameters and batches."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.data import TokenStream
    from repro_torch.train import init_state, make_train_step

    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    tc = TrainConfig(**PARITY_KW)
    t0 = time.perf_counter()
    cpu = init_state(c32, tc, 0, device="cpu", draw="device")
    card = _tree_to(cpu, "cuda")
    log(f"  f32 state drawn on the host and copied to the card in "
        f"{time.perf_counter() - t0:.1f} s")
    stream = TokenStream(vocab=cfg.vocab, batch=PARITY_B, seq_len=PARITY_S,
                         seed=0)
    step = make_train_step(c32, tc)
    for i in range(PARITY_STEPS):
        b = stream.batch_at(i)
        t0 = time.perf_counter()
        cpu, mc = step(cpu, b)
        t_cpu = time.perf_counter() - t0
        card, mg = step(card, b)
        lc, lg = float(mc["total_loss"]), float(mg["total_loss"])
        gc, gg = float(mc["grad_norm"]), float(mg["grad_norm"])
        check(abs(lc - lg) <= 1e-4 * abs(lc),
              f"f32 step {i + 1}: loss {lg} on the card, {lc} on the CPU")
        check(abs(gc - gg) <= 1e-3 * abs(gc),
              f"f32 step {i + 1}: grad_norm {gg} on the card, {gc} on the "
              f"CPU")
        log(f"  f32 step {i + 1} (B {PARITY_B}, S {PARITY_S}): loss card "
            f"{lg:.6f} / CPU {lc:.6f}, grad_norm {gg:.6f} / {gc:.6f}; the "
            f"CPU step took {t_cpu:.1f} s")
    d = _tree_max_diff(card["params"], cpu["params"])
    check(d <= 1e-5, f"f32 parameters after step {PARITY_STEPS} differ by "
          f"{d} between the card and the CPU")
    log(f"  f32 parameters after step {PARITY_STEPS}: max |card - CPU| "
        f"{d:.3g} (limit 1e-5)")


def qwen_bf16_train(torch, FK, K, cfg, smi):
    """Three bf16 steps at B = 4, S = 512 through ``make_train_step``
    (remat block), the port's kernel counts at 0 over them; the warm
    step's time, memory, busy share and bound; microbatches 2 against 1."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.hw import H100
    from repro_torch.common.schema import count_params
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.train import init_state, make_train_step

    check(cfg.remat == "block" and cfg.compute_dtype == "bfloat16",
          f"{cfg.name}: remat {cfg.remat}, compute {cfg.compute_dtype}")
    n_params = count_params(T.model_schema(cfg))
    tc = TrainConfig()
    stream = TokenStream(vocab=cfg.vocab, batch=BF16_B, seq_len=BF16_S,
                         seed=0)
    state = init_state(cfg, tc, 0, device="cuda", draw="device")
    step = make_train_step(cfg, tc)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(BF16_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    FK.reset_launch_counts()
    K.reset_launch_counts()
    times = []
    for i, b in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, b)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        loss, gn = float(m["total_loss"]), float(m["grad_norm"])
        check(torch.isfinite(m["total_loss"]) and torch.isfinite(
            m["grad_norm"]), f"bf16 step {i + 1}: loss {loss}, grad_norm "
            f"{gn}")
        log(f"  bf16 step {i + 1}: loss {loss:.4f}, grad_norm {gn:.4f}, lr "
            f"{float(m['lr']):.3g}, {times[-1]:.2f} ms (CUDA events)")
    peak = torch.cuda.max_memory_allocated()
    flash = FK.launch_counts()["flash_attention"]
    gas = sum(K.launch_counts().values())
    check(flash == 0 and gas == 0 and FK.flash_attention_plain.calls == 0,
          f"training reached the port's kernels: flash {flash}, GAS {gas}")
    # the dry run of this step on fake card tensors, and on fake CPU ones
    # (what a machine without CUDA traces): the same numbers
    from repro_torch.common.config import ShapeConfig
    shape = ShapeConfig("chip_c_train", BF16_S, BF16_B, "train")
    pred = dry_run_memory(cfg, shape, None, tc)
    pred_cpu = dry_run_memory(cfg, shape, None, tc, device="cpu")
    same = ("peak_bytes_per_device", "traced_args_bytes", "dot_flops")
    check(all(pred[k] == pred_cpu[k] for k in same),
          f"the dry run on fake {pred['fake_device']} tensors "
          f"{[pred[k] for k in same]} against fake CPU tensors "
          f"{[pred_cpu[k] for k in same]}")
    check(pred["dot_flops"] > 0 and pred["traced_args_bytes"] > 0,
          f"an empty dry run: {pred}")
    hold_peak(f"{cfg.name} bf16 step (B {BF16_B}, S {BF16_S}, one card)",
              peak, base, pred, smi)
    log(f"  the same dry run on fake cpu tensors: peak "
        f"{pred_cpu['peak_bytes_per_device']} B, dot FLOPs "
        f"{pred_cpu['dot_flops']:.6g} (fake {pred['fake_device']}: "
        f"{pred['peak_bytes_per_device']} B, {pred['dot_flops']:.6g})")
    tokens = BF16_B * BF16_S
    warm = min(times[1:])
    flops = 8 * n_params * tokens
    bound_ms = flops / H100.peak_flops_bf16 * 1e3
    log(f"  {cfg.name} bf16 training [{smi}]: {n_params / 1e9:.3f} B "
        f"params, {tokens} tokens a step; warm step {warm:.2f} ms "
        f"({tokens / warm * 1e3:.0f} tokens/s); peak memory "
        f"{peak / 2**30:.2f} GiB; bound 8·N·tokens = {flops / 1e12:.3f} "
        f"TFLOP over {H100.peak_flops_bf16 / 1e12:.0f} TFLOP/s = "
        f"{bound_ms:.3f} ms ({100 * bound_ms / warm:.1f}% of the warm "
        f"step); port kernel launches over {BF16_STEPS} steps: flash 0 "
        f"(refused under autograd), GAS 0")
    wall, device, hosts, kernels = profile_call(
        torch, lambda: step(state, batches[0]))
    n_launch = device_launches(torch, lambda: step(state, batches[0]))
    log(f"  profile of one warm bf16 step (profiler on): wall {wall:.1f} ms,"
        f" device time {device:.2f} ms ({100 * device / wall:.1f}% busy), "
        f"{n_launch} device kernel launches a step;"
        " top host ops (self CPU ms): "
        + "; ".join(f"{k} x{n} {ms:.1f}" for k, n, ms in hosts)
        + "; top device kernels (ms): "
        + "; ".join(f"{k} x{n} {ms:.2f}" for k, n, ms in kernels))
    # the step consumes its state: microbatches 1 steps from a copy
    _, m1 = step(_tree_clone(state), batches[0])
    _, m2 = make_train_step(cfg, dataclasses.replace(tc, microbatches=2))(
        state, batches[0])
    l1, l2 = float(m1["total_loss"]), float(m2["total_loss"])
    check(abs(l1 - l2) <= 1e-2 * abs(l1),
          f"bf16 microbatches=2 loss {l2} against {l1} at 1")
    log(f"  bf16 microbatches=2: loss {l2:.5f} against {l1:.5f} at 1 "
        f"(rtol 1e-2)")


def recurrent_serving(torch, arch, smi):
    """``launch.serve --workload lm`` at the published width (bf16), then
    f32 teacher-forced decode against the full forward and bf16 logits
    finite, on parameters drawn on the card."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.common.schema import count_params, init_params
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.train import make_prefill_step

    cfg = configs.get_config(arch)
    argv = ["--workload", "lm", "--arch", arch, "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN)]
    t0 = time.perf_counter()
    check(serve.main(argv) == 0, f"serve.main({argv}) failed")
    log(f"  launch.serve {' '.join(argv)}: {time.perf_counter() - t0:.1f} s "
        f"with the draw [{smi}]")
    schema = T.model_schema(cfg, max_seq=LM_PROMPT + LM_GEN)
    params = init_params(schema, 0, device="cuda", draw="device")
    batch = serve.lm_batch(cfg, LM_BATCH, LM_PROMPT, seed=0)
    forced = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (LM_BATCH, LM_GEN)).astype(np.int32)).cuda()
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = serve.generate(params, batch, c32, gen=LM_GEN, use_flash=False,
                         forced=forced)
    prompt = torch.from_numpy(batch["tokens"]).cuda()
    fulls = []
    with torch.no_grad():
        for i in range(LM_GEN - 1):
            seq = torch.cat([prompt, forced[:, :i + 1]], dim=1)
            fulls.append(make_prefill_step(c32, cache_len=seq.shape[1])(
                params, {"tokens": seq})[0][:, :cfg.vocab])
    # atol 1e-3, or 1e-5 of the largest logit where that is larger: the
    # tied table's rows have norm ~sqrt(d_model), so the logits reach
    # 1e2 and their f32 rounding through 26-48 layers ~1e-5 of that
    scale = max(float(f.abs().max()) for f in fulls)
    atol = max(1e-3, 1e-5 * scale)
    worst = 0.0
    for i, full in enumerate(fulls):
        ok, d = _close(out["logits"][i + 1][:, :cfg.vocab], full, 1e-4,
                       atol)
        worst = max(worst, d)
        check(ok, f"{arch} f32 decode step {i + 1} off the full forward by "
              f"{d} (atol {atol:.3g})")
    log(f"  {arch} ({count_params(schema) / 1e9:.3f} B params) f32: "
        f"{LM_GEN - 1} teacher-forced decode steps match the full forward, "
        f"max |diff| {worst:.3g} of logits up to {scale:.1f} (rtol 1e-4, "
        f"atol {atol:.3g})")
    times = []
    for _ in range(2):
        bo = serve.generate(params, batch, cfg, gen=LM_GEN, use_flash=False)
        check(all(bool(torch.isfinite(lg[:, :cfg.vocab]).all())
                  for lg in bo["logits"]), f"{arch} bf16: non-finite logits")
        times.append(bo)
    steps = LM_GEN - 1
    log(f"  {arch} bf16 [{smi}]: logits finite; prefill "
        + ", ".join(f"{o['prefill_s'] * 1e3:.2f}" for o in times)
        + " ms; decode "
        + ", ".join(f"{o['decode_s'] * 1e3 / steps:.3f}" for o in times)
        + " ms/step")


def ssd_train_step(torch, smi):
    from repro_torch import configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.data import TokenStream
    from repro_torch.train import init_state, make_train_step

    cfg = configs.get_config("mamba2-780m")
    tc = TrainConfig()
    state = init_state(cfg, tc, 0, device="cuda", draw="device")
    b = TokenStream(vocab=cfg.vocab, batch=SSD_TRAIN_B, seq_len=SSD_TRAIN_S,
                    seed=0).batch_at(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = make_train_step(cfg, tc)(state, b)
    loss = float(m["total_loss"])
    check(bool(torch.isfinite(m["total_loss"])) and bool(
        torch.isfinite(m["grad_norm"])), f"mamba2-780m train step: loss "
        f"{loss}")
    log(f"  mamba2-780m train step (B {SSD_TRAIN_B}, S {SSD_TRAIN_S}, bf16, "
        f"remat {cfg.remat}): loss {loss:.4f}, grad_norm "
        f"{float(m['grad_norm']):.4f}, {time.perf_counter() - t0:.2f} s "
        f"host clock, first call [{smi}]")


def smoke_archs_on_card(torch):
    """Each architecture the new kinds serve, at smoke size: one train
    step, prefill and 4 decode steps on the card against the CPU."""
    from repro_torch import configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.tree import leaves
    from repro_torch.data import TokenStream
    from repro_torch.launch import serve
    from repro_torch.train import init_state, make_train_step

    tc = TrainConfig(**SMOKE_KW)
    for arch in NEW_ARCHS:
        cfg = configs.smoke_config(arch)
        cpu = init_state(cfg, tc, 0, max_seq=SMOKE_P + SMOKE_STEPS + 1,
                         device="cpu")
        card = _tree_to(cpu, "cuda")
        batch = serve.lm_batch(cfg, SMOKE_B, SMOKE_P, seed=0)
        want = serve.generate(cpu["params"], batch, cfg, gen=SMOKE_STEPS + 1,
                              use_flash=False)
        got = serve.generate(card["params"], batch, cfg,
                             gen=SMOKE_STEPS + 1, use_flash=False,
                             forced=want["tokens"].cuda())
        worst = 0.0
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            ok, d = _close(g, w, 1e-4, 2e-4)
            worst = max(worst, d)
            check(ok, f"{arch} smoke: logits {i} off the CPU by {d}")
        tb = TokenStream(vocab=cfg.vocab, batch=SMOKE_B, seq_len=16,
                         with_vision=cfg.vision_seq,
                         d_model=cfg.d_model).batch_at(0)
        step = make_train_step(cfg, tc)
        cpu, mc = step(cpu, tb)
        card, mg = step(card, tb)
        lc, lg = float(mc["total_loss"]), float(mg["total_loss"])
        check(abs(lc - lg) <= 1e-4 * abs(lc), f"{arch} smoke: train loss "
              f"{lg} on the card, {lc} on the CPU")
        ok = all(_close(a, b, 1e-4, 2e-4)[0] for a, b in zip(
            leaves(card["params"]), leaves(cpu["params"])))
        dp = _tree_max_diff(card["params"], cpu["params"])
        check(ok, f"{arch} smoke: parameters after a step off the CPU by "
              f"{dp}")
        log(f"  {arch} (smoke: {', '.join(cfg.pattern)}): prefill + "
            f"{SMOKE_STEPS} decode logits max |card - CPU| {worst:.3g}; "
            f"train loss {lg:.5f} / {lc:.5f}, aux "
            f"{float(mg['aux_loss']):.4f}; parameters {dp:.3g}")


def phase_lm_train(torch, FK, K, smi):
    """Phase c."""
    from repro_torch import configs

    t_phase = time.perf_counter()
    flash_refusal_on_card(torch, FK)
    cfg = configs.get_config(LM_TRAIN_ARCH)
    t0 = time.perf_counter()
    qwen_parity(torch, cfg)
    log(f"  f32 parity took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qwen_bf16_train(torch, FK, K, cfg, smi)
    log(f"  bf16 training took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    for arch in RECURRENT_ARCHS:
        t0 = time.perf_counter()
        recurrent_serving(torch, arch, smi)
        torch.cuda.empty_cache()
        log(f"  {arch} serving took {time.perf_counter() - t0:.1f} s")
    ssd_train_step(torch, smi)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    smoke_archs_on_card(torch)
    log(f"  the seven smoke architectures took "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"  phase c took {time.perf_counter() - t_phase:.1f} s")


def graph_phases(torch, phases, dev, measured, launches, smi):
    """Phases 2-4, 7 and 8: the FAST-GAS kernels, graph serving, inference,
    training, and all of it sharded."""
    import numpy as np

    from repro_torch.configs.graphic_gcn import CONFIG, PALLAS_CONFIG
    from repro_torch.core.gcn import (feature_table, gcn_schema, sage_forward,
                                      sage_loss)
    from repro_torch.common.schema import init_params
    from repro_torch.data import GraphBatchStream, synthetic_node_labels
    from repro_torch.graph import uniform_graph
    from repro_torch.kernels.gas_scatter import kernel as K
    from repro_torch.kernels.gas_scatter import ops
    from repro_torch.launch.serve import replay_traffic
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    g = uniform_graph(V, DEGREE * V, seed=0, n_features=F)
    indptr, indices, _ = g.to_csr()
    labels = synthetic_node_labels(g.features, CONFIG.n_classes, seed=0)
    stream = GraphBatchStream(g, labels, 1, BATCH, k1=FANOUT, k2=FANOUT,
                              seed=0)
    batch = stream.batch_at(0)
    log(f"  graph V={V} E={DEGREE * V} F={F} and batch made in "
        f"{time.perf_counter() - t0:.1f} s")

    if "2" in phases:
        log("phase 2: kernels against their plain versions")
        table = feature_table(g.features, device=dev).reshape(V, F)
        chunk = PALLAS_CONFIG.request_chunk
        req_rng = np.random.default_rng(1)
        serve_seeds = req_rng.integers(0, V, 3)
        from repro_torch.graph import host_sample_csr
        s_nbrs, s_mask = host_sample_csr(indptr, indices, serve_seeds, FANOUT,
                                         seed=0)
        shapes = {
            # inference: one 16-row command-queue chunk of the 2-hop segment
            "gas_scatter_banded": (
                torch.from_numpy(batch["nbrs2"][0, :chunk]).to(dev),
                torch.from_numpy(batch["mask2"][0, :chunk].copy()).to(dev)),
            # serving, scheduled=False: one 3-seed request's fan-out segment
            "gas_scatter_dense": (torch.from_numpy(s_nbrs).to(dev),
                                  torch.from_numpy(s_mask).to(dev)),
        }
        measured.update(phase_kernels(torch, ops, K, table, shapes,
                                        smi))
        measured.update(phase_kernels_narrow(torch, ops, K, table, shapes,
                                             smi))
        check_skip_inputs(torch, ops, table, shapes["gas_scatter_banded"])
        del table
        torch.cuda.empty_cache()

    if "3" in phases:
        log("phase 3: serving")
        ref = serve(ServingEngine, replay_traffic, g.features, indptr, indices,
                    impl="ref")
        for scheduled, kernel in ((True, "gas_scatter_banded"),
                                  (False, "gas_scatter_dense")):
            K.reset_launch_counts()
            got = serve(ServingEngine, replay_traffic, g.features, indptr,
                        indices, impl="kernel", scheduled=scheduled)
            counts = K.launch_counts()
            log(f"  launches with scheduled={scheduled}: {counts}")
            check(counts[kernel] > 0, f"serving never launched {kernel}")
            for name in counts:
                launches[name] += counts[name]
            compare_serving(ref, got, f"scheduled={scheduled}")
        # bf16 and f16 tables of integer features, the hot cache on
        tables = narrow_tables(torch, g.features)
        for sfx, table in tables.items():
            host_dtype = torch.bfloat16 if sfx == "bf16" else np.float16
            ref = serve(ServingEngine, replay_traffic, table, indptr, indices,
                        impl="ref")
            for scheduled, kernel in ((True, "gas_scatter_banded"),
                                      (False, "gas_scatter_dense")):
                K.reset_launch_counts()
                got = serve(ServingEngine, replay_traffic, table, indptr,
                            indices, impl="kernel", scheduled=scheduled)
                counts = K.dtype_launch_counts()
                log(f"  {sfx} launches with scheduled={scheduled}: {counts}")
                check(counts[kernel][sfx] > 0,
                      f"{sfx} serving never launched {kernel}_{sfx}")
                check(all(n == 0 for by in counts.values()
                          for d, n in by.items() if d != sfx),
                      f"{sfx} serving launched another type's kernel")
                add_dtype_launches(launches, counts)
                compare_serving_exact(ref, got, f"{sfx} scheduled={scheduled}",
                                      host_dtype)
                if sfx == "bf16" and scheduled:
                    off = serve(ServingEngine, replay_traffic, table, indptr,
                                indices, cache=0, impl="kernel",
                                scheduled=True)
                    compare_serving_exact(off, got, "bf16 cache on",
                                          host_dtype, "the cache off")
        del tables

    if "4" in phases:
        # inference builds no autograd graph
        with torch.no_grad():
            log("phase 4: inference")
            feats = feature_table(g.features, device=dev)
            params = init_params(gcn_schema(PALLAS_CONFIG), 0, device=dev)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            logits = sage_forward(params, feats, batch, PALLAS_CONFIG)
            torch.cuda.synchronize()
            t_kernel = time.perf_counter() - t0
            counts = K.launch_counts()
            log(f"  launches: {counts}")
            check(counts["gas_scatter_banded"] > 0,
                  "inference never launched gas_scatter_banded")
            for name in counts:
                launches[name] += counts[name]
            want = sage_forward(params, feats, batch, CONFIG)
            # warm timings, after the counted run: one more call of each
            timed = {}
            for label, cfg in (("kernel", PALLAS_CONFIG), ("ref", CONFIG)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sage_forward(params, feats, batch, cfg)
                torch.cuda.synchronize()
                timed[label] = time.perf_counter() - t0
            check(tuple(logits.shape) == (1, BATCH, CONFIG.n_classes),
                  f"logits shape {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            err = float((logits - want).abs().max())
            check(torch.allclose(logits, want, rtol=1e-4, atol=1e-4),
                  f"logits off the ref by {err}")
            loss, metrics = sage_loss(params, feats, batch, PALLAS_CONFIG)
            check(bool(torch.isfinite(loss)), "non-finite loss")
            wall, device, hosts, _ = profile_call(
                torch,
                lambda: sage_forward(params, feats, batch, PALLAS_CONFIG))
            log(f"  profile of one warm kernel sage_forward (profiler on): "
                f"wall {wall:.1f} ms, device time {device:.2f} ms "
                f"({100 * device / wall:.1f}% busy); top host ops (self CPU "
                "ms): " + "; ".join(f"{k} x{n} {ms:.1f}"
                                    for k, n, ms in hosts))
            log(f"  logits {tuple(logits.shape)} finite, max |kernel - ref| "
                f"{err:.3g}; loss {float(loss):.4f}; sage_forward "
                f"{t_kernel * 1e3:.1f} ms (kernel, first call); warm "
                f"{timed['kernel'] * 1e3:.1f} ms (kernel, "
                f"{PALLAS_CONFIG.request_chunk}-row chunks) vs "
                f"{timed['ref'] * 1e3:.1f} ms (ref, unchunked)")

    if "7" in phases:
        log("phase 7: training at full width")
        measured.setdefault("gas_scatter_dense", {})["gather_backward"] = \
            phase_train(torch, K, g, stream, dev, launches, smi)

    if "8" in phases:
        log(f"phase 8: sharded at full width, {SHARDS} ranks on one card")
        phase_sharded(torch, K, g, indptr, indices, dev, launches, smi)



# ---------------------------------------------------------------------------
# phase 7: training at full width
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3
# kernel scatters of the coalesced sage fetch per forward + backward: one
# forward fan-out scatter and one backward scatter of the gather's
# cotangent (the JAX package's SAGE_FETCH_KERNEL_SCATTERS_FWD_BWD)
FETCH_KERNEL_SCATTERS_FWD_BWD = 2


def loss_and_grads(torch, sage_loss, params, feats, batch, cfg, mesh=None):
    """(loss, {name: gradient}, pre-activations) of ``sage_loss`` in the
    parameters. The pre-activations are the inputs of every ``torch.relu``
    call of this same forward (for ``sage_forward``: the two layers'), so
    the ReLU decisions are those the gradient was taken at: on the card
    ``index_add_`` adds in no fixed order, and a second forward may put a
    pre-activation within summation noise of 0 on the other side. On a
    sharded ``mesh`` the loss is the global one and the gradients are
    summed over the ranks (an all-reduce outside any count)."""
    from repro_torch.core import collectives

    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    pre, real = [], torch.relu

    def recording(x):
        pre.append(x.detach())
        return real(x)
    torch.relu = recording
    try:
        loss, metrics = sage_loss(live, feats, batch, cfg, mesh=mesh)
    finally:
        torch.relu = real
    keys = sorted(live)
    grads = torch.autograd.grad(loss, [live[k] for k in keys])
    if mesh is not None:
        grads = [collectives.all_reduce(g, mesh) for g in grads]
    return metrics["loss"], dict(zip(keys, grads)), pre


def flipped_units(pre_a, pre_b):
    """Per layer, the hidden units where two forwards' ReLU decisions
    differ on some row: a pre-activation within f32 summation noise of 0
    that one aggregation order puts on each side. Such a flip moves the
    gradient of the layer's weight column and bias by one term (a jump,
    not noise); a second-layer flip also reaches every unit of the first
    layer through the backward."""
    check(len(pre_a) == len(pre_b),
          f"{len(pre_a)} against {len(pre_b)} ReLU calls")
    return [((a > 0) != (b > 0)).reshape(-1, a.shape[-1]).any(0)
            for a, b in zip(pre_a, pre_b)]


def counted(torch, K, launches, fn):
    """Run ``fn`` with every launch count set to 0 just before; add the
    counts read just after to ``launches`` and return (result, counts)."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for name in counts:
        launches[name] += counts[name]
    return out, counts


def phase_train(torch, K, g, stream, dev, launches, smi):
    """(a) three AdamW steps of ``make_sage_train_step`` at
    ``PALLAS_CONFIG`` against ``CONFIG``; (b) the feature table's gradient
    through both GAS backward rules: add at full width (the gather's
    backward on the dense grid), max at one chunk's shape (the tie count
    on the banded walk). Returns the dense grid's timing at the gather's
    backward."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.schema import init_params
    from repro_torch.configs.graphic_gcn import CONFIG, PALLAS_CONFIG
    from repro_torch.core import cgtrans, gas
    from repro_torch.core.gcn import (feature_table, gcn_schema,
                                      sage_forward, sage_loss)
    from repro_torch.kernels.gas_scatter import ops
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_sage_train_step

    feats = feature_table(g.features, device=dev)
    params = init_params(gcn_schema(PALLAS_CONFIG), 0, device=dev)
    batches = [{k: torch.from_numpy(v.copy()).to(dev)
                for k, v in stream.batch_at(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    # the launch.train / examples/train_graphsage.py optimiser
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=20, total_steps=300,
                     weight_decay=0.01)
    with torch.no_grad():
        K.reset_launch_counts()
        sage_forward(params, feats, batches[0], PALLAS_CONFIG)
        torch.cuda.synchronize()
        per_batch = K.launch_counts()
    check(per_batch["gas_scatter_banded"] > 0
          and per_batch["gas_scatter_dense"] == 0,
          f"one inference batch launched {per_batch}")

    # (a) the train step, kernel against ref, from the same params
    cfgs = {"kernel": PALLAS_CONFIG, "ref": CONFIG}
    states = {n: {"params": {k: v.clone() for k, v in params.items()},
                  "opt": adamw_init(params, tc),
                  "step": torch.zeros((), dtype=torch.int32, device=dev)}
              for n in cfgs}
    steps = {n: make_sage_train_step(c, tc, feats=feats)
             for n, c in cfgs.items()}
    for i in range(TRAIN_STEPS):
        b = batches[i]
        # both backends' loss and gradients at the kernel run's parameters
        lk, gk, pk = loss_and_grads(torch, sage_loss,
                                    states["kernel"]["params"], feats, b,
                                    PALLAS_CONFIG)
        lr_, gr, pr = loss_and_grads(torch, sage_loss,
                                     states["kernel"]["params"], feats, b,
                                     CONFIG)
        check(bool(torch.isfinite(lk)) and bool(torch.isfinite(lr_)),
              f"step {i}: non-finite loss {float(lk)} / {float(lr_)}")
        check(torch.allclose(lk, lr_, rtol=1e-4, atol=0.0),
              f"step {i}: loss {float(lk)} vs ref {float(lr_)}")
        # gradient columns a ReLU flip between the backends moves
        flip1, flip2 = flipped_units(pk, pr)
        if bool(flip2.any()):
            flip1 = torch.ones_like(flip1)
        moved = {"w0": flip1, "b0": flip1, "w1": flip2, "b1": flip2}
        n_flip = (int(flip1.sum()), int(flip2.sum()))
        check(n_flip[1] <= 2 and (n_flip[0] <= 8 or n_flip[1]),
              f"step {i}: ReLU decisions differ on {n_flip} units")
        worst, worst_moved = 0.0, 0.0
        for k in gr:
            scale = float(gr[k].abs().max())
            check(bool(torch.isfinite(gk[k]).all()),
                  f"step {i}: non-finite gradient {k}")
            keep = ~moved.get(k, torch.zeros(gr[k].shape[-1], dtype=bool,
                                             device=dev))
            a, w = gk[k][..., keep], gr[k][..., keep]
            err = float((a - w).abs().max()) if a.numel() else 0.0
            check(torch.allclose(a, w, rtol=1e-4, atol=1e-4 * scale),
                  f"step {i}: gradient {k} off by {err} (max |g| {scale})")
            worst = max(worst, err / max(scale, 1e-30))
            if not bool(keep.all()):
                d = float((gk[k][..., ~keep] - gr[k][..., ~keep]).abs().max())
                worst_moved = max(worst_moved, d / max(scale, 1e-30))
        (states["kernel"], mk), counts = counted(
            torch, K, launches, lambda: steps["kernel"](states["kernel"], b))
        check(counts == per_batch,
              f"step {i} launched {counts}, one inference batch {per_batch}")
        states["ref"], mr = steps["ref"](states["ref"], b)
        tk, tr = mk["total_loss"], mr["total_loss"]
        check(bool(torch.isfinite(tk)) and bool(torch.isfinite(tr)),
              f"step {i}: non-finite step loss")
        check(torch.allclose(tk, tr, rtol=1e-4, atol=0.0),
              f"step {i}: step loss {float(tk)} vs ref {float(tr)}")
        log(f"  step {i}: loss {float(tk):.6f} (ref {float(tr):.6f}); at "
            f"equal params loss {float(lk):.6f} vs {float(lr_):.6f}, "
            f"gradients within {worst:.3g} of max|g| per leaf; ReLU "
            f"flips on {n_flip} units, their columns within "
            f"{worst_moved:.3g}; grad_norm "
            f"{float(mk['grad_norm']):.4f}, lr {float(mk['lr']):.3g}; "
            f"launches {counts}")
    timed = {}
    for n in ("kernel", "ref", "ref", "kernel"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps[n](states[n], batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        timed.setdefault(n, []).append((time.perf_counter() - t0) * 1e3)
    profile_call(torch, lambda: torch.ones(1, device=dev) + 1)  # set-up
    wall, device, hosts, kernels = profile_call(
        torch, lambda: steps["kernel"](states["kernel"], batches[TRAIN_STEPS]))
    log(f"  warm train step [{smi}]: kernel "
        + ", ".join(f"{t:.1f}" for t in timed["kernel"]) + " ms, ref "
        + ", ".join(f"{t:.1f}" for t in timed["ref"]) + " ms")
    log(f"  profile of one warm kernel train step (profiler on): wall "
        f"{wall:.1f} ms, device time {device:.2f} ms "
        f"({100 * device / wall:.1f}% busy); top host ops (self CPU ms): "
        + "; ".join(f"{k} x{n} {ms:.1f}" for k, n, ms in hosts)
        + "; top device kernels (ms): "
        + "; ".join(f"{k} x{n} {ms:.2f}" for k, n, ms in kernels))
    del states, steps

    # (b) d/dfeats, add, full width, unchunked, coalesced fetch
    b = batches[0]
    Vn, Fn = feats.shape[1], feats.shape[2]
    seeds = b["seeds"].to(torch.int32)
    flat1 = torch.cat([seeds[..., None], b["nbrs1"].to(torch.int32)],
                      dim=-1).reshape(1, -1)
    blocks = ((flat1[..., None], torch.ones(flat1.shape + (1,),
                                            dtype=torch.bool, device=dev)),
              (b["nbrs2"].to(torch.int32), b["mask2"].to(torch.bool)))
    gen = torch.Generator(device=dev).manual_seed(5)
    us = [torch.randn((1, n.shape[1], Fn), generator=gen, device=dev)
          for n, _ in blocks]

    def fetch_grad(impl):
        f = feats.detach().requires_grad_(True)
        with gas.count_dispatches() as c:
            outs = cgtrans.aggregate_multi(f, blocks, impl=impl)
            sum((o * u).sum() for o, u in zip(outs, us)).backward()
        return f.grad, dict(c)

    (gk, ck), counts = counted(torch, K, launches,
                               lambda: fetch_grad("kernel"))
    check(counts == {"gas_scatter_banded": 1, "gas_scatter_dense": 1},
          f"d/dfeats fwd+bwd launched {counts}")
    check(ck["kernel_scatter"] == FETCH_KERNEL_SCATTERS_FWD_BWD,
          f"d/dfeats fwd+bwd counted {ck}")
    gr, cr = fetch_grad("ref")
    check(bool(torch.isfinite(gk).all()), "non-finite table gradient")
    err = float((gk - gr).abs().max())
    check(torch.allclose(gk, gr, rtol=1e-5, atol=1e-5),
          f"table gradient off impl=ref by {err}")
    n_ids = sum(n.numel() for n, _ in blocks)
    log(f"  d/dfeats (add, {n_ids} ids over {Vn} rows, unchunked): "
        f"launches {counts}, dispatches {ck} (ref {cr}); table gradient "
        f"max |kernel - ref| {err:.3g} (max |g| {float(gr.abs().max()):.3g})")
    del gk, gr

    # the gather's backward scatter alone: its kernel call, timed
    seen = []
    real = ops.gas_scatter_fused

    def recording(*args, **kwargs):
        if kwargs.get("schedule") is None:
            seen.append((args, kwargs))
        return real(*args, **kwargs)
    ops.gas_scatter_fused = recording
    try:
        fetch_grad("kernel")
    finally:
        ops.gas_scatter_fused = real
    check(len(seen) == 1, f"{len(seen)} unscheduled scatters in fwd+bwd")
    args, kwargs = seen[0]
    call = ops.fused_call(*args, **kwargs)
    check(call.kernel == "gas_scatter_dense", f"backward took {call.kernel}")
    ids, _, starts, vals, R = call.args
    plan = K.dense_plan(ids.shape[0], R, vals.shape[1])
    log_plan("gas_scatter_dense", plan, call,
             f"{int(starts[-1])} live edges (gather backward)")
    t = {"values": list(vals.shape), "rows": R,
         "live_edges": int(starts[-1]), "ms": event_ms(torch, call.run, 5),
         "device_ms": device_ms(torch, call.run,
                                KERNEL_SYMBOL["gas_scatter_dense"], 5),
         "library_ms": event_ms(torch, library_fn(torch, call), 5),
         "plain_ms": event_ms(torch, call.run_plain, 1, warm=0)}
    t["bound_ms"], t["bound_by"] = bound(call)
    log(f"  gas_scatter_dense at the gather backward [{smi}]: "
        f"{json.dumps(t)}")
    del call, seen, args, vals

    # (c) d/dfeats, max, one chunk of the fan-out segment, integer data.
    # Each (seed, sample) reads its own table row, so every table row takes
    # one share and the shares (g / ties) are held bit for bit.
    chunk = PALLAS_CONFIG.request_chunk
    nb = b["nbrs2"][0, :chunk].long()
    mk = b["mask2"][0, :chunk].to(torch.bool)
    small = torch.round(feats.reshape(-1, Fn)[nb.reshape(-1)] * 4)[None]
    ids = torch.arange(nb.numel(), dtype=torch.int32,
                       device=dev).reshape(1, *nb.shape)
    u = torch.randint(-4, 5, (1, chunk, Fn), generator=gen, device=dev
                      ).to(torch.float32)

    def max_grad(impl):
        f = small.clone().requires_grad_(True)
        out = cgtrans.aggregate_sampled(f, ids, mk[None], op="max",
                                        impl=impl)
        (out * u).sum().backward()
        return out.detach(), f.grad

    (ok_, gk), counts = counted(torch, K, launches,
                                lambda: max_grad("kernel"))
    check(counts == {"gas_scatter_banded": 2, "gas_scatter_dense": 1},
          f"max fwd+bwd launched {counts}")
    orf, gr = max_grad("ref")
    check(torch.equal(ok_, orf), "max forward differs from impl=ref")
    check(torch.equal(gk, gr), f"max table gradient not bit-exact: "
          f"{float((gk - gr).abs().max())}")
    rows = small[0].reshape(chunk, -1, Fn)
    ties = ((rows == orf[0][:, None]) & mk[:, :, None]).sum(1)
    log(f"  d/dfeats (max, {chunk} seeds x {nb.shape[1]} samples, integer "
        f"data): launches {counts}; gradient bit-exact with impl=ref; "
        f"{int((ties > 1).sum())} of {ties.numel()} cells split among ties "
        f"(up to {int(ties.max())})")
    check(int((ties > 1).sum()) > 0, "no tie to split")
    return t


# ---------------------------------------------------------------------------
# phase 8: the sharded dataflows, SHARDS ranks sharing the card
# ---------------------------------------------------------------------------

SHARDS = 4
SHARD_BATCH = BATCH // SHARDS        # 16 seeds per rank, 64 in all
# a bf16 table's drains ship bf16 partials and answers on wire="f32"
BF16_TABLE_WAIVER = ("narrow-wire",)
BF16_TABLE_WAIVER_REASON = (
    "a bf16 table's drain ships its own dtype's partials and answers on "
    "wire='f32', the port's choice for bf16 tables; the JAX package "
    "registers no contract for a bf16 table")
SHARD_TIMEOUT_S = 600
DRAIN_N = (1, 8)


def _foreign_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "repro", "ml_dtypes"))


def shard_rank(mesh, spec):
    """One rank of phase 8: its table interval and its slice of every
    batch; each path of the run with the launch, collective and dispatch
    counts set to 0 just before it and read just after."""
    import numpy as np
    import torch

    from repro_torch.common.config import TrainConfig
    from repro_torch.configs.graphic_gcn import PALLAS_CONFIG
    from repro_torch.core import cgtrans
    from repro_torch.core.gcn import feature_table, sage_forward, sage_loss
    from repro_torch.kernels.gas_scatter import kernel as K
    from repro_torch.launch.counts import count_run
    from repro_torch.launch.mesh import host
    from repro_torch.launch.serve import replay_traffic
    from repro_torch.optim import adamw_init
    from repro_torch.serving import ServingEngine
    from repro_torch.train import make_sage_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    load = lambda name: np.load(os.path.join(spec["dir"], name + ".npy"),  # noqa
                                mmap_mode="r")
    table = load("feats")
    feats = feature_table(table, mesh.size, mesh=mesh, device=dev)
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in mesh.shard(b).items()} for b in spec["batches"]]
    out = {"launches": {}, "dtype_launches": {}, "counts": {}, "bytes": {},
           "runs": {}, "engine": {}, "steps": []}

    def path(name, fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        run = count_run(fn)
        torch.cuda.synchronize()
        out["launches"][name] = K.launch_counts()
        out["dtype_launches"][name] = K.dtype_launch_counts()
        out["counts"][name] = run.as_dict()
        out["bytes"][name] = dict(run.bytes)
        res, run.output = run.output, None
        out["runs"][name] = run
        return res

    def timed(fn):
        """(host ms, staged-collective ms) of one warm call."""
        mesh.barrier()
        torch.cuda.synchronize()
        s0, t0 = mesh.staged.seconds, time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3,
                (mesh.staged.seconds - s0) * 1e3)

    # (a) the coalesced fetch on integer-valued rows, unchunked, kernel
    b0 = batches[0]
    seeds = b0["seeds"].to(torch.int32)
    flat1 = torch.cat([seeds[..., None], b0["nbrs1"].to(torch.int32)],
                      dim=-1).reshape(1, -1)
    blocks = ((flat1[..., None], torch.ones(flat1.shape + (1,),
                                            dtype=torch.bool, device=dev)),
              (b0["nbrs2"].to(torch.int32), b0["mask2"].to(torch.bool)))
    with torch.no_grad():
        ints = torch.round(feats * 4)
        for op in ("add", "max"):
            got = path(f"fetch_{op}", lambda: cgtrans.aggregate_multi(
                ints, blocks, mesh=mesh, op=op, impl="kernel"))
            out[f"fetch_{op}"] = [host(o) for o in got]
        base = path("fetch_add_baseline", lambda: cgtrans.aggregate_multi(
            ints, blocks, mesh=mesh, dataflow="baseline", impl="kernel"))
        out["baseline_equal"] = all(
            np.array_equal(host(a), b) for a, b in zip(base, out["fetch_add"]))
        del ints, base

    # (b) inference at PALLAS_CONFIG
    params = {k: torch.from_numpy(v).to(dev)
              for k, v in spec["params"].items()}
    cfg = PALLAS_CONFIG
    with torch.no_grad():
        logits = path("forward", lambda: sage_forward(params, feats, b0, cfg,
                                                      mesh=mesh))
        out["logits"] = host(logits)
        out["forward_ms"] = [timed(lambda: sage_forward(
            params, feats, b0, cfg, mesh=mesh)) for _ in range(2)]

    # (c) three AdamW steps; the loss and gradients at each step's params
    tc = TrainConfig(**spec["tc"])
    step = make_sage_train_step(cfg, tc, feats=feats, mesh=mesh)
    state = {"params": params, "opt": adamw_init(params, tc),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    for i in range(TRAIN_STEPS):
        loss, grads, pre = loss_and_grads(torch, sage_loss, state["params"],
                                          feats, batches[i], cfg, mesh=mesh)
        before = host(state["params"])
        state, m = path(f"step{i}", lambda: step(state, batches[i]))
        out["steps"].append({"params": before, "loss": float(loss),
                             "grads": host(grads),
                             "pre": [host(x) for x in pre],
                             "step_loss": float(m["total_loss"])})
    out["step_ms"] = [timed(lambda: step(state, batches[TRAIN_STEPS]))
                      for _ in range(2)]
    out["params_after"] = host(state["params"])
    del state, step, feats

    # (d) serving: the same replay on every rank, the table sharded
    indptr, indices = load("indptr"), load("indices")
    for scheduled in (True, False):
        eng = ServingEngine(table, indptr, indices, fanout=FANOUT,
                            max_batch=MAX_BATCH, cache_capacity=CACHE,
                            clock=fake_clock(), sample_seed=0, mesh=mesh,
                            impl="kernel", scheduled=scheduled)
        rids, _ = path(f"serve_{scheduled}", lambda: replay_traffic(
            eng, requests=REQUESTS, tenants=TENANTS, seed=0))
        out[f"serve_{scheduled}"] = {r: eng.result(r) for r in rids}
        out[f"stats_{scheduled}"] = dict(eng.stats)
    for n in DRAIN_N:
        eng = ServingEngine(table, indptr, indices, fanout=FANOUT,
                            max_batch=MAX_BATCH, clock=fake_clock(),
                            sample_seed=0, mesh=mesh, impl="kernel")
        for j in range(n):
            eng.submit([j, j + 1], tenant=j)
        path(f"drain_{n}", eng.flush)
        out["engine"][f"drain_{n}"] = dict(eng.stats)

    # (e) the same serving on phase 3's bf16 table (integer features),
    # read through its bits: the replay, banded and dense, and the drains
    bf16 = torch.from_numpy(load("feats_bf16")).view(torch.bfloat16)
    for scheduled in (True, False):
        eng = ServingEngine(bf16, indptr, indices, fanout=FANOUT,
                            max_batch=MAX_BATCH, cache_capacity=CACHE,
                            clock=fake_clock(), sample_seed=0, mesh=mesh,
                            impl="kernel", scheduled=scheduled)
        rids, _ = path(f"serve_bf16_{scheduled}", lambda: replay_traffic(
            eng, requests=REQUESTS, tenants=TENANTS, seed=0))
        out[f"serve_bf16_{scheduled}"] = {r: eng.result(r) for r in rids}
    for n in DRAIN_N:
        eng = ServingEngine(bf16, indptr, indices, fanout=FANOUT,
                            max_batch=MAX_BATCH, clock=fake_clock(),
                            sample_seed=0, mesh=mesh, impl="kernel")
        for j in range(n):
            eng.submit([j, j + 1], tenant=j)
        path(f"drain_bf16_{n}", eng.flush)
        out["engine"][f"drain_bf16_{n}"] = dict(eng.stats)
    out["staged"] = dataclasses.asdict(mesh.staged)
    out["modules"] = _foreign_modules()
    return out


def nccl_wrappers(torch, dev):
    """Each collective wrapper on a 1-rank NCCL group, on device tensors of
    the dataflow's dtypes; each returns its input."""
    import tempfile
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.launch.mesh import make_data_mesh

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_data_mesh(1, backend="nccl", device="cuda")
            ids = torch.arange(-1, 816 * 51, dtype=torch.int32, device=dev)
            payload = torch.randn(1, 1632, F + 1, device=dev)
            with collectives.count_collectives() as c:
                outs = (collectives.all_gather(ids, mesh)[0],
                        collectives.all_to_all(payload, mesh),
                        collectives.all_reduce(payload, mesh),
                        collectives.reduce_scatter(payload, mesh)[None])
            torch.cuda.synchronize()
            for x, y in zip((ids, payload, payload, payload), outs):
                check(x.dtype == y.dtype and torch.equal(x, y),
                      f"NCCL 1-rank wrapper changed a {x.dtype} input")
            check(c.as_dict() == {"all_gather": 1, "all_to_all": 1,
                                  "psum": 1, "psum_scatter": 1},
                  f"NCCL wrappers counted {c.as_dict()}")
        finally:
            dist.destroy_process_group()
    log(f"  NCCL 1-rank group ({mesh.backend}, {mesh.device}): all_gather "
        f"int32, all_to_all / all_reduce / reduce_scatter f32 each return "
        f"their input; counted {c.as_dict()}")


def phase_sharded(torch, K, g, indptr, indices, dev, launches, smi):
    """Phase 8: spawn SHARDS gloo ranks on the one card and hold them
    against the unsharded port on the same inputs."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.analysis import budgets, contracts
    from repro_torch.analysis.dtype_flow import check_dtype_flow
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.schema import init_params
    from repro_torch.configs.graphic_gcn import CONFIG, PALLAS_CONFIG
    from repro_torch.core import cgtrans
    from repro_torch.core.gcn import (feature_table, gcn_schema,
                                      sage_forward, sage_loss)
    from repro_torch.data import GraphBatchStream, synthetic_node_labels
    from repro_torch.launch.mesh import host, spawn
    from repro_torch.launch.serve import replay_traffic
    from repro_torch.optim import adamw_init
    from repro_torch.serving import ServingEngine
    from repro_torch.train import make_sage_train_step

    t_phase = time.perf_counter()
    labels = synthetic_node_labels(g.features, CONFIG.n_classes, seed=0)
    # the same 64 seeds and samples as phase 4's batch, laid out 4 x 16
    stream = GraphBatchStream(g, labels, SHARDS, SHARD_BATCH, k1=FANOUT,
                              k2=FANOUT, seed=0)
    batches = [stream.batch_at(i) for i in range(TRAIN_STEPS + 1)]
    params = host(init_params(gcn_schema(PALLAS_CONFIG), 0, device="cpu"))
    tc = dict(learning_rate=3e-3, warmup_steps=20, total_steps=300,
              weight_decay=0.01)
    work = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        # phase 3's bf16 table, saved as its int16 bits
        bf16 = narrow_tables(torch, g.features)["bf16"]
        for name, arr in (("feats", g.features), ("indptr", indptr),
                          ("indices", indices),
                          ("feats_bf16", bf16.view(torch.int16).numpy())):
            np.save(os.path.join(work, name + ".npy"), arr)
        spec = {"dir": work, "batches": batches, "params": params, "tc": tc}
        t0 = time.perf_counter()
        ranks = spawn(shard_rank, SHARDS, backend="gloo", device="cuda",
                      timeout_s=SHARD_TIMEOUT_S, args=(spec,))
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  {SHARDS} gloo ranks on one card (collectives staged through "
        f"pinned host memory; no interconnect) ran in {t_ranks:.1f} s")
    for r, res in enumerate(ranks):
        check(res["modules"] == [], f"rank {r} imported {res['modules']}")

    # launches: each path must launch the kernels it runs
    should = {"fetch_add": "gas_scatter_banded",
              "fetch_max": "gas_scatter_banded",
              "fetch_add_baseline": "gas_scatter_banded",
              "forward": "gas_scatter_banded",
              "serve_True": "gas_scatter_banded",
              "serve_False": "gas_scatter_dense",
              "serve_bf16_True": "gas_scatter_banded_bf16",
              "serve_bf16_False": "gas_scatter_dense_bf16",
              **{f"step{i}": "gas_scatter_banded"
                 for i in range(TRAIN_STEPS)}}
    for r, res in enumerate(ranks):
        for name, counts in res["dtype_launches"].items():
            flat = {k: 0 for k in launches}
            add_dtype_launches(flat, counts)
            if name in should:
                check(flat[should[name]] > 0,
                      f"rank {r} path {name} never launched {should[name]}")
            add_dtype_launches(launches, counts)
    check(all(res["launches"][f"step{i}"]["gas_scatter_dense"] == 0
              for res in ranks for i in range(TRAIN_STEPS)),
          "a train step launched the dense grid")
    log("  launches per rank: " + "; ".join(
        f"rank {r} " + ", ".join(
            f"{n} {c['gas_scatter_banded']}b/{c['gas_scatter_dense']}d"
            for n, c in res["launches"].items())
        for r, res in enumerate(ranks)))

    # counts against the contract registry at full width: the unchunked
    # fetch is aggregate_multi on the banded walk (the kernel route's
    # default); sage_forward and the step stream PALLAS_CONFIG's two
    # segments in chunks; a drain is the fused fetch plus the result
    # gather (the engine counts its dispatches in its own stats)
    reg = lambda name: contracts.CONTRACTS[name].forward  # noqa: E731
    coll = lambda c: {k: v for k, v in c.items()  # noqa: E731
                      if k not in budgets.DISPATCH_KEYS}
    drain = {**coll(reg("serving_fetch/fused/pallas")),
             "result_gather": budgets.RESULT_GATHER_PER_DRAIN}
    want = {
        "fetch_add": reg("aggregate_multi/cgtrans/pallas/sched"),
        "fetch_max": reg("aggregate_multi/cgtrans/pallas/sched"),
        "fetch_add_baseline": reg("aggregate_multi/baseline/pallas/sched"),
        "forward": contracts.chunked(
            reg("sage_forward/coalesced/pallas/sched"), 2),
        **{f"step{i}": contracts.chunked(
            reg("train_step/coalesced/pallas/sched"), 2)
           for i in range(TRAIN_STEPS)},
        **{f"drain{t}_{n}": drain for n in DRAIN_N for t in ("", "_bf16")},
    }
    # a drain of SERVE_CONTRACT_N requests dispatches what the contract does
    n_c = budgets.SERVE_CONTRACT_N
    engine_want = {k: v for k, v in reg("serving_fetch/fused/pallas").items()
                   if k in budgets.DISPATCH_KEYS}
    for r, res in enumerate(ranks):
        for name, budget in want.items():
            check(res["counts"][name] == budget,
                  f"rank {r} {name} counted {res['counts'][name]}, "
                  f"budget {budget}")
        for t in ("", "_bf16"):
            stats = res["engine"][f"drain{t}_{n_c}"]
            got = {k: stats[k] for k in budgets.DISPATCH_KEYS}
            check(got == engine_want, f"rank {r} drain{t}_{n_c} dispatched "
                  f"{got}, budget {engine_want}")
        for name, run in res["runs"].items():
            waive = BF16_TABLE_WAIVER if "bf16" in name else ()
            issues = check_dtype_flow(run, waive=waive)
            check(not issues, f"rank {r} {name}: dtype {issues}")
    log("  collectives per forward " + json.dumps(coll(
        ranks[0]["counts"]["forward"])) + ", per step " + json.dumps(coll(
            ranks[0]["counts"]["step0"])) + ", per drain N=1 " + json.dumps(
        coll(ranks[0]["counts"]["drain_1"])) + ", N=8 " + json.dumps(coll(
            ranks[0]["counts"]["drain_8"])) + " (equal to the contract "
        "registry's budgets; every path's dtypes clean, the bf16 table's "
        f"under the narrow-wire waiver: {BF16_TABLE_WAIVER_REASON})")
    # a drain of n two-seed requests: per rank a (1, 1) lookup and a
    # (1, FANOUT) fan-out segment each
    for r, res in enumerate(ranks):
        for n in DRAIN_N:
            got = {}
            for t, size in (("", 4), ("_bf16", 2)):
                want_b = budgets.drain_bytes(SHARDS, n * (1 + FANOUT), 2 * n,
                                             F, size, "add")
                got[t] = res["bytes"][f"drain{t}_{n}"]
                check(got[t] == want_b, f"rank {r} drain{t}_{n} moved "
                      f"{got[t]} bytes, budget {want_b}")
            check(all(2 * got["_bf16"][k] == got[""][k]
                      for k in ("all_to_all", "result_gather")),
                  f"rank {r} drain_{n}: bf16 partials not half of f32's")
    log(f"  bytes per drain per rank (N = {DRAIN_N[-1]}): f32 table "
        f"{ranks[0]['bytes'][f'drain_{DRAIN_N[-1]}']}, bf16 table "
        f"{ranks[0]['bytes'][f'drain_bf16_{DRAIN_N[-1]}']} (equal to "
        f"budgets.drain_bytes; the bf16 partials and answers half of f32's)")
    cb = sum(ranks[0]["bytes"]["fetch_add"].values())
    bb = sum(ranks[0]["bytes"]["fetch_add_baseline"].values())
    check(bb / cb > FANOUT / 4, f"bytes ratio {bb / cb} <= K/4")
    log(f"  bytes per coalesced fetch per rank: cgtrans {cb} "
        f"{ranks[0]['bytes']['fetch_add']}, baseline {bb} "
        f"{ranks[0]['bytes']['fetch_add_baseline']}; ratio {bb / cb:.2f} "
        f"> K/4 = {FANOUT / 4} (the reference's bound, "
        f"tests/distributed_cases.py)")

    full = feature_table(g.features, SHARDS, device=dev)
    with torch.no_grad():
        # (a) the fetch on integer rows, bit for bit with the unsharded
        # kernel fetch; baseline bit for bit with cgtrans
        gb = {k: torch.from_numpy(v.copy()).to(dev)
              for k, v in batches[0].items()}
        seeds = gb["seeds"].to(torch.int32)
        flat1 = torch.cat([seeds[..., None], gb["nbrs1"].to(torch.int32)],
                          dim=-1).reshape(SHARDS, -1)
        blocks = ((flat1[..., None], torch.ones(flat1.shape + (1,),
                                                dtype=torch.bool,
                                                device=dev)),
                  (gb["nbrs2"].to(torch.int32), gb["mask2"].to(torch.bool)))
        ints = torch.round(full * 4)
        for op in ("add", "max"):
            want_o = [host(o) for o in cgtrans.aggregate_multi(
                ints, blocks, op=op, impl="kernel")]
            for r, res in enumerate(ranks):
                for a, b in zip(res[f"fetch_{op}"], want_o):
                    check(np.array_equal(a, b[r:r + 1]),
                          f"rank {r} fetch {op} differs from the unsharded "
                          f"kernel fetch")
        check(all(res["baseline_equal"] for res in ranks),
              "baseline fetch differs from cgtrans")
        del ints
        log("  coalesced fetch on integer rows (add, max): every rank bit "
            "for bit with the unsharded kernel fetch; baseline bit for bit "
            "with cgtrans")

        # (b) logits against the unsharded kernel logits (phase 4's)
        pdev = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        want_l = host(sage_forward(pdev, full, batches[0], PALLAS_CONFIG))
        got_l = np.concatenate([res["logits"] for res in ranks])
        check(np.isfinite(got_l).all(), "non-finite sharded logits")
        err = float(np.abs(got_l - want_l).max())
        check(np.allclose(got_l, want_l, rtol=1e-4, atol=1e-4),
              f"sharded logits off the unsharded kernel logits by {err}")
        log(f"  sharded logits {got_l.shape} within {err:.3g} of the "
            f"unsharded kernel logits (rtol = atol = 1e-4)")

    # (c) training: the sharded kernel steps against unsharded impl=ref
    ref_step = make_sage_train_step(CONFIG, TrainConfig(**tc), feats=full)
    ref_state = {"params": dict(pdev), "opt": adamw_init(pdev, TrainConfig(
        **tc)), "step": torch.zeros((), dtype=torch.int32, device=dev)}
    for i in range(TRAIN_STEPS):
        steps = [res["steps"][i] for res in ranks]
        for r, st in enumerate(steps[1:], 1):
            check(all(np.array_equal(st["params"][k], steps[0]["params"][k])
                      for k in st["params"]),
                  f"step {i}: rank {r}'s params differ from rank 0's")
        at = {k: torch.from_numpy(v).to(dev)
              for k, v in steps[0]["params"].items()}
        lr_, gr, pr = loss_and_grads(torch, sage_loss, at, full, batches[i],
                                     CONFIG)
        pk = [torch.from_numpy(np.concatenate([st["pre"][j] for st in steps]
                                              )).to(dev)
              for j in range(len(pr))]
        flip1, flip2 = flipped_units(pk, pr)
        if bool(flip2.any()):
            flip1 = torch.ones_like(flip1)
        moved = {"w0": flip1, "b0": flip1, "w1": flip2, "b1": flip2}
        n_flip = (int(flip1.sum()), int(flip2.sum()))
        check(n_flip[1] <= 2 and (n_flip[0] <= 8 or n_flip[1]),
              f"step {i}: ReLU decisions differ on {n_flip} units")
        lk = steps[0]["loss"]
        check(abs(lk - float(lr_)) <= 1e-4 * abs(float(lr_)),
              f"step {i}: sharded loss {lk} vs ref {float(lr_)}")
        worst = 0.0
        for k in gr:
            gk = torch.from_numpy(steps[0]["grads"][k]).to(dev)
            scale = float(gr[k].abs().max())
            keep = ~moved.get(k, torch.zeros(gr[k].shape[-1], dtype=bool,
                                             device=dev))
            a, w = gk[..., keep], gr[k][..., keep]
            e = float((a - w).abs().max()) if a.numel() else 0.0
            check(torch.allclose(a, w, rtol=1e-4, atol=1e-4 * scale),
                  f"step {i}: gradient {k} off by {e} (max |g| {scale})")
            worst = max(worst, e / max(scale, 1e-30))
        ref_state, mr = ref_step(ref_state, batches[i])
        tk, tr = steps[0]["step_loss"], float(mr["total_loss"])
        check(all(st["step_loss"] == tk for st in steps),
              f"step {i}: the ranks report different losses")
        check(np.isfinite(tk) and abs(tk - tr) <= 1e-4 * abs(tr),
              f"step {i}: sharded step loss {tk} vs ref {tr}")
        log(f"  step {i}: sharded loss {tk:.6f} (unsharded ref {tr:.6f}); "
            f"at equal params {lk:.6f} vs {float(lr_):.6f}, gradients "
            f"within {worst:.3g} of max|g| per leaf; ReLU flips on "
            f"{n_flip} units")
    del full, ref_state, ref_step

    # (d) serving against the unsharded kernel engine
    for scheduled in (True, False):
        want_s = serve(ServingEngine, replay_traffic, g.features, indptr,
                       indices, impl="kernel", scheduled=scheduled)
        for r, res in enumerate(ranks):
            compare_serving(want_s, res[f"serve_{scheduled}"],
                            f"rank {r} of {SHARDS}, scheduled={scheduled}",
                            "the unsharded kernel engine")
        log(f"  sharded engine stats (scheduled={scheduled}, rank 0): "
            f"{ranks[0][f'stats_{scheduled}']}; collectives of the replay "
            f"{coll(ranks[0]['counts'][f'serve_{scheduled}'])}")
    # (e) the bf16 table against the unsharded bf16 kernel engine
    for scheduled in (True, False):
        want_s = serve(ServingEngine, replay_traffic, bf16, indptr, indices,
                       impl="kernel", scheduled=scheduled)
        for r, res in enumerate(ranks):
            compare_serving_exact(
                want_s, res[f"serve_bf16_{scheduled}"],
                f"bf16 rank {r} of {SHARDS}, scheduled={scheduled}",
                torch.bfloat16, "the unsharded bf16 kernel engine")
    del bf16

    nccl_wrappers(torch, dev)

    # timings (host clock, synchronised; not interconnect numbers)
    fwd = [ms for res in ranks for ms, _ in res["forward_ms"][1:]]
    stp = [ms for res in ranks for ms, _ in res["step_ms"][1:]]
    r0 = ranks[0]
    share_f = r0["forward_ms"][1][1] / r0["forward_ms"][1][0]
    share_s = r0["step_ms"][1][1] / r0["step_ms"][1][0]
    log(f"  warm sharded [{smi}; {SHARDS} ranks on one card, gloo staged "
        f"through host memory, not an interconnect]: sage_forward "
        f"{min(fwd):.1f}-{max(fwd):.1f} ms, train step "
        f"{min(stp):.1f}-{max(stp):.1f} ms across ranks; rank 0's staged "
        f"collective share {100 * share_f:.1f}% of the forward, "
        f"{100 * share_s:.1f}% of the step; staged over the run "
        f"{json.dumps(r0['staged'])}")
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: full-graph GCN on one card, and over the mesh
# ---------------------------------------------------------------------------

GCN_V = 1 << 18                      # 2^18 vertices, 16 in-edges each
GCN_SHARD_V, GCN_SHARD_E = 1 << 14, 1 << 18
GCN_SPARSE_E = 1 << 20               # edges of the unsharded sparse check
GCN_OPS = ("add", "max")


def gcn_grads(torch, forward, params, cot, masks=None):
    """(gradients of sum(logits · cot) in every parameter, the inputs of
    every ``torch.relu`` of this same forward). With ``masks`` (one per
    ReLU call) each ReLU applies that decision in place of its own, so
    two backends can be differentiated at the same decisions."""
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    pre, real, calls = [], torch.relu, iter(masks or ())

    def recording(x):
        pre.append(x.detach())
        if masks is None:
            return real(x)
        return x * next(calls).to(x.dtype)
    torch.relu = recording
    try:
        loss = (forward(live) * cot).sum()
    finally:
        torch.relu = real
    keys = sorted(live)
    grads = torch.autograd.grad(loss, [live[k] for k in keys])
    return dict(zip(keys, grads)), pre


def hold_grads(torch, gk, gr, moved, label, dev):
    """Each leaf within rtol = atol = 1e-4 of max|g| outside ``moved``
    columns; returns the worst error over max|g|."""
    worst = 0.0
    for k in gr:
        scale = float(gr[k].abs().max())
        check(bool(torch.isfinite(gk[k]).all()), f"{label}: non-finite {k}")
        keep = ~moved.get(k, torch.zeros(gr[k].shape[-1], dtype=torch.bool,
                                         device=dev))
        a, w = gk[k][..., keep], gr[k][..., keep]
        err = float((a - w).abs().max()) if a.numel() else 0.0
        check(torch.allclose(a, w, rtol=1e-4, atol=1e-4 * scale),
              f"{label}: gradient {k} off by {err} (max |g| {scale})")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def captured_calls(ops, fn, scheduled):
    """Run ``fn`` and return the (args, kwargs) of every
    ``ops.gas_scatter_fused`` call it made with (``scheduled``) or without
    a schedule."""
    seen, real = [], ops.gas_scatter_fused

    def recording(*args, **kwargs):
        if (kwargs.get("schedule") is not None) == scheduled:
            seen.append((args, kwargs))
        return real(*args, **kwargs)
    ops.gas_scatter_fused = recording
    try:
        fn()
    finally:
        ops.gas_scatter_fused = real
    return seen


def time_call(torch, ops, K, args, kwargs, label, smi, iters, plain=True):
    """Time one captured kernel call: CUDA events, the profiler's device
    ms, the bound, ``torch.sparse.mm`` on the same function, and, for the
    banded walk, the wrapper's pad copy and (with ``plain``) one walk of
    the plain version."""
    values = args[1]
    call = ops.fused_call(*args, **kwargs)
    name = call.kernel
    vals = call.args[-2]    # the value stream, or the gathered walk's table
    t = {"values": [call.args[1].shape[0], vals.shape[1]],
         "rows": call.args[-1],
         "ms": event_ms(torch, call.run, iters, warm=1),
         "device_ms": device_ms(torch, call.run, KERNEL_SYMBOL[name], iters)}
    t["bound_ms"], t["bound_by"] = bound(call)
    lib = library_fn(torch, call)
    t["library_ms"] = event_ms(torch, lib, iters, warm=1)
    del lib
    if name.startswith("gas_scatter_banded"):
        if plain:
            # one plain walk: a Python loop over the work list's rows
            t["plain_ms"] = event_ms(torch, call.run_plain, 1, warm=0)
        work = call.args[0]
        t["pad_ms"] = event_ms(torch, lambda: ops._padded_values(
            values, edges=name == "gas_scatter_banded"), iters, warm=1)
        t["work"] = list(work.shape)
    else:
        t["live_edges"] = int(call.args[2][-1])
    log(f"  {name} at {label} [{smi}]: {json.dumps(t)}")
    del call, vals
    torch.cuda.empty_cache()
    return t


def gcn_rank(mesh, spec):
    """One rank of phase 9's sharded part: its interval of the integer
    table and its slice of the edges; each run with the collective and
    dispatch counts set to 0 just before it and read just after."""
    import numpy as np
    import torch

    from repro_torch.core import cgtrans
    from repro_torch.kernels.gas_scatter import kernel as K
    from repro_torch.launch.counts import count_run
    from repro_torch.launch.mesh import host

    dev, r = mesh.device, mesh.rank
    load = lambda name: torch.from_numpy(np.array(  # noqa
        np.load(os.path.join(spec["dir"], name + ".npy"),
                mmap_mode="r")[r:r + 1])).to(dev)
    ints, relu = load("ints"), load("relu")
    src, dst, w, mask = (load(k) for k in ("src", "dst", "w", "mask"))
    out = {"launches": {}, "counts": {}, "bytes": {}, "rows": {}, "runs": {}}

    def run(name, fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        counted = count_run(fn)
        torch.cuda.synchronize()
        res, counted.output = counted.output, None
        out["launches"][name] = K.launch_counts()
        out["counts"][name] = counted.as_dict()
        out["bytes"][name] = dict(counted.bytes)
        out["runs"][name] = counted
        out["rows"][name] = [host(x) for x in res] if isinstance(
            res, tuple) else host(res)

    with torch.no_grad():
        for flow in ("cgtrans", "baseline"):
            for op in GCN_OPS:
                run(f"{flow}/{op}/f32", lambda: cgtrans.aggregate_edges(
                    ints, src, dst, w, mask, mesh=mesh, dataflow=flow, op=op,
                    impl="kernel"))
        for wire in ("bf16", "int8"):
            table = ints if wire == "bf16" else spec["floats"][r:r + 1]
            table = torch.as_tensor(table, device=dev)
            run(f"cgtrans/add/{wire}", lambda: cgtrans.aggregate_edges(
                table, src, dst, w, mask, mesh=mesh, op="add",
                impl="kernel", wire=wire))
        run("baseline/add/sparse", lambda: cgtrans.aggregate_edges(
            relu, src, dst, w, mask, mesh=mesh, dataflow="baseline",
            impl="kernel", features="sparse", sparse_capacity=spec["cap"]))
        nb = torch.from_numpy(spec["nbrs"][r:r + 1]).to(dev)
        mk = torch.ones(nb.shape, dtype=torch.bool, device=dev)
        run("fetch/add/bf16", lambda: cgtrans.aggregate_multi(
            ints, ((nb, mk),), mesh=mesh, impl="kernel", wire="bf16"))
    out["staged"] = dataclasses.asdict(mesh.staged)
    out["modules"] = _foreign_modules()
    return out


def edges_contract(flow, op, wire):
    """The registry's contract for one of phase 9's sharded runs (all on
    the kernel route): sparse features change no budget, so the baseline's
    sparse run is held to its dense twin's."""
    if flow == "fetch":
        return "aggregate_multi/cgtrans/pallas/bf16"
    if wire in ("bf16", "int8"):
        return f"aggregate_edges/{flow}/{op}/xla/{wire}"
    return f"aggregate_edges/{flow}/{op}/pallas"


def gcn_sharded(torch, dev, launches, smi):
    """Phase 9 (d): SHARDS gloo ranks on the card, at V = 2^14 and
    E = 2^18 with F = 602, against the unsharded port on the same inputs."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.analysis import budgets, contracts
    from repro_torch.analysis.dtype_flow import check_dtype_flow
    from repro_torch.core import cgtrans
    from repro_torch.core.sparse import sparse_fits, table_capacity
    from repro_torch.graph import partition_by_src, uniform_graph
    from repro_torch.launch.mesh import spawn

    g = uniform_graph(GCN_SHARD_V, GCN_SHARD_E, seed=1, n_features=F,
                      weights=True)
    pg = partition_by_src(g, SHARDS)
    rng = np.random.default_rng(9)
    ints = rng.integers(-8, 9, pg.features.shape).astype(np.float32)
    relu = np.maximum(ints, 0)
    cap = table_capacity(relu)
    check(sparse_fits(cap, F), f"sparse capacity {cap} does not fit F={F}")
    w = np.ones_like(pg.weights)            # unit weights: exact sums
    nbrs = rng.integers(0, GCN_SHARD_V, (SHARDS, 64, 16)).astype(np.int32)
    arrays = {"ints": ints, "relu": relu, "src": pg.src, "dst": pg.dst,
              "w": w, "mask": pg.mask}
    work = tempfile.mkdtemp(prefix="chip_smoke_gcn_")
    try:
        for name, arr in arrays.items():
            np.save(os.path.join(work, name + ".npy"), arr)
        spec = {"dir": work, "cap": cap, "nbrs": nbrs,
                "floats": pg.features}
        t0 = time.perf_counter()
        ranks = spawn(gcn_rank, SHARDS, backend="gloo", device="cuda",
                      timeout_s=SHARD_TIMEOUT_S, args=(spec,))
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  {SHARDS} gloo ranks on one card at V={GCN_SHARD_V}, "
        f"E={GCN_SHARD_E}, F={F} (part {pg.part_size}, {pg.e_max} edge "
        f"slots per rank) ran in {t_ranks:.1f} s")
    for r, res in enumerate(ranks):
        check(res["modules"] == [], f"rank {r} imported {res['modules']}")
        for name, counts in res["launches"].items():
            check(counts["gas_scatter_banded"] > 0,
                  f"rank {r} {name} never launched gas_scatter_banded")
            for k in counts:
                launches[k] += counts[k]

    # the unsharded port on the same inputs
    T = lambda x: torch.from_numpy(x).to(dev)  # noqa
    src, dst, wt, mask = T(pg.src), T(pg.dst), T(w), T(pg.mask)
    want = {}
    with torch.no_grad():
        for op in GCN_OPS:
            want[op] = cgtrans.aggregate_edges(T(ints), src, dst, wt, mask,
                                               op=op, impl="kernel").cpu()
        want["float"] = cgtrans.aggregate_edges(T(pg.features), src, dst, wt,
                                                mask, impl="kernel").cpu()
        want["relu"] = cgtrans.aggregate_edges(T(relu), src, dst, wt, mask,
                                               impl="kernel").cpu()
        flat = T(ints).reshape(1, -1, F)
        fetch = cgtrans.aggregate_multi(flat, ((T(nbrs).reshape(1, -1, 16),
                                                torch.ones((1, SHARDS * 64,
                                                            16), dtype=torch
                                                           .bool,
                                                           device=dev)),),
                                        impl="kernel")[0].cpu().reshape(
                                            SHARDS, 64, F)
    part, e_loc = pg.part_size, pg.e_max
    lines = []
    for r, res in enumerate(ranks):
        for name, rows in res["rows"].items():
            flow, op, wire = name.split("/")
            counts, nbytes = res["counts"][name], res["bytes"][name]
            contract = contracts.CONTRACTS[edges_contract(flow, op, wire)]
            budget = dict(contract.forward)
            if contract.impl == "ref":
                # JAX registers the narrow wire's edges on xla only; the
                # kernel route adds its one kernel scatter, as every
                # aggregate_edges/.../pallas contract does over its twin
                budget = budgets.merge(budget, {"kernel_scatter": 1})
            check(counts == budget, f"rank {r} {name} counted {counts}, "
                  f"budget {budget} ({contract.name})")
            issues = check_dtype_flow(res["runs"][name],
                                      waive=contract.dtype_waivers)
            check(not issues, f"rank {r} {name}: dtype {issues}")
            if flow == "fetch":
                got = torch.from_numpy(rows[0])
                check(torch.equal(got[0], fetch[r]),
                      f"rank {r} bf16 fetch differs from the unsharded fetch")
                # the int16 delta ids: 2 bytes per id from each rank
                check(nbytes["all_gather"] == SHARDS * 64 * 16 * 2,
                      f"rank {r} {name} id bytes {nbytes}")
                continue
            got = torch.from_numpy(rows)[0]
            ref = want["float" if wire == "int8" else
                       "relu" if wire == "sparse" else op][r]
            if wire == "int8":
                fin = torch.isfinite(ref)
                span = float(ref[fin].abs().max())
                err = float((got[fin] - ref[fin]).abs().max())
                check(torch.equal(torch.isfinite(got), fin)
                      and err <= 0.02 * span + 1e-6,
                      f"rank {r} {name}: err {err} over span {span}")
            else:
                check(torch.equal(got, ref),
                      f"rank {r} {name} differs from the unsharded port")
            nb = budgets.edges_bytes(flow, "f32" if wire == "sparse"
                                     else wire, SHARDS, part, F, e_loc)
            check(sum(nbytes.values()) == nb,
                  f"rank {r} {name} moved {nbytes}, formula {nb}")
            if r == 0:
                lines.append(f"{name} {sum(nbytes.values())} B {counts}")
    log("  sharded, every rank bit for bit with the unsharded port (int8 "
        "within 2% of the span), counts equal the contract registry's "
        "budgets and dtypes clean under its waivers, bytes equal "
        "budgets.edges_bytes; rank 0: " + "; ".join(lines))
    log(f"  staged collectives of rank 0 [{smi}; gloo through host memory, "
        f"not an interconnect]: {json.dumps(ranks[0]['staged'])}")


def phase_gcn(torch, K, dev, launches, smi):
    """Phase 9: (a) ``gcn_forward_full`` at Reddit width, kernel against
    ref, forward and parameter gradients, add and max; (b)
    ``aggregate_edges`` on integer data, every op, bit for bit; (c) the
    wire and sparse knobs as no-ops; (d) sharded; (e) times. Returns the
    timed kernel calls per kernel."""
    import numpy as np

    from repro_torch.common.schema import init_params
    from repro_torch.configs.graphic_gcn import PALLAS_CONFIG
    from repro_torch.core import cgtrans
    from repro_torch.core.gcn import gcn_forward_full, gcn_schema
    from repro_torch.core.sparse import sparse_fits, table_capacity
    from repro_torch.graph import partition_by_src, uniform_graph
    from repro_torch.kernels.gas_scatter import ops

    t_phase = time.perf_counter()
    g = uniform_graph(GCN_V, DEGREE * GCN_V, seed=0, n_features=F,
                      weights=True)
    pg = partition_by_src(g, 1)
    T = lambda x: torch.from_numpy(x).to(dev)  # noqa
    feats = T(pg.features)
    edges = tuple(T(x) for x in (pg.src, pg.dst, pg.weights, pg.mask))
    del g
    E = edges[0].shape[1]
    log(f"  graph V={GCN_V} E={E} F={F} (E·F = {E * F:,} values, "
        f"{E * F * 4 / 1e9:.2f} GB gathered per layer-0 aggregation) made "
        f"in {time.perf_counter() - t_phase:.1f} s")
    params = init_params(gcn_schema(PALLAS_CONFIG), 0, device=dev)
    C = PALLAS_CONFIG.n_classes
    gen = torch.Generator(device=dev).manual_seed(9)
    cot = torch.randn((1, GCN_V, C), generator=gen, device=dev)
    out = {}

    # (a) the forward and the parameters' gradients, kernel against ref
    for op in GCN_OPS:
        cfg = dataclasses.replace(PALLAS_CONFIG, aggregate=op)
        ref_cfg = dataclasses.replace(cfg, impl="ref", scheduled=None)
        fwd = lambda p, c: gcn_forward_full(p, feats, *edges, c)  # noqa
        with torch.no_grad():
            logits, counts = counted(torch, K, launches,
                                     lambda: fwd(params, cfg))
            check(counts == {"gas_scatter_banded": 2,
                             "gas_scatter_dense": 0},
                  f"{op}: the forward launched {counts}")
            want = fwd(params, ref_cfg)
        check(tuple(logits.shape) == (1, GCN_V, C),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"{op}: non-finite logits")
        err = float((logits - want).abs().max())
        check(torch.allclose(logits, want, rtol=1e-4, atol=1e-4),
              f"{op}: logits off the ref by {err}")
        del logits, want
        (gk, pk), gcounts = counted(torch, K, launches, lambda: gcn_grads(
            torch, lambda p: fwd(p, cfg), params, cot))
        want_b = {"gas_scatter_banded": 2 + (op != "add"),
                  "gas_scatter_dense": 1}
        check(gcounts == want_b, f"{op}: fwd+bwd launched {gcounts}")
        gr, pr = gcn_grads(torch, lambda p: fwd(p, ref_cfg), params, cot)
        flip1, flip2 = flipped_units(pk, pr)
        n_flip = (int(flip1.sum()), int(flip2.sum()))
        if bool(flip2.any()):
            flip1 = torch.ones_like(flip1)
        moved = {"w0": flip1, "b0": flip1, "w1": flip2, "b1": flip2}
        worst = hold_grads(torch, gk, gr, moved, f"{op} (phase 7 rule)", dev)
        # and at the kernel run's ReLU decisions, every column
        gs, _ = gcn_grads(torch, lambda p: fwd(p, ref_cfg), params, cot,
                          masks=[x > 0 for x in pk])
        worst_all = hold_grads(torch, gk, gs, {}, f"{op} (same decisions)",
                               dev)
        log(f"  gcn_forward_full op={op}: logits {(1, GCN_V, C)} finite, max "
            f"|kernel - ref| {err:.3g}; launches forward {counts}, forward + "
            f"backward {gcounts}; gradients within {worst:.3g} of max|g| "
            f"per leaf outside ReLU-flipped columns (flips on {n_flip} "
            f"units), within {worst_all:.3g} on every column at equal ReLU "
            f"decisions")
        del gk, gr, gs, pk, pr
        torch.cuda.empty_cache()

    # (b) aggregate_edges on integer data, E·F over 2^31, bit for bit
    ints = torch.randint(-8, 9, feats.shape, generator=gen, device=dev).to(
        torch.float32)
    unit = torch.ones_like(edges[2])
    src, dst, _, mask = edges
    for op in ("add", "max", "min", "or"):
        got, c = counted(torch, K, launches, lambda: cgtrans.aggregate_edges(
            ints, src, dst, unit, mask, op=op, impl="kernel"))
        check(c["gas_scatter_banded"] == 1, f"{op}: launched {c}")
        want = cgtrans.aggregate_edges(ints, src, dst, unit, mask, op=op,
                                       impl="ref")
        check(torch.equal(got, want), f"aggregate_edges op={op}: kernel and "
              f"ref differ by {float((got - want).abs().max())}")
        del got, want
        torch.cuda.empty_cache()
    log(f"  aggregate_edges on integer data (E·F = {E * F:,} > 2^31): add, "
        "max, min, or kernel bit for bit with impl=ref")

    # (c) the knobs unsharded: the wire a no-op, sparse bit for bit dense
    with torch.no_grad():
        base = cgtrans.aggregate_edges(ints, *edges, impl="kernel")
        for wire in ("bf16", "int8"):
            check(torch.equal(cgtrans.aggregate_edges(
                ints, *edges, impl="kernel", wire=wire), base),
                f"wire={wire} is not a no-op unsharded")
        del base
        relu = torch.clamp(ints, min=0)
        cap = table_capacity(relu)
        check(sparse_fits(cap, F), f"capacity {cap} does not fit F={F}")
        sub = tuple(x[:, :GCN_SPARSE_E] for x in edges)
        got = cgtrans.aggregate_edges(relu, *sub, impl="kernel",
                                      features="sparse", sparse_capacity=cap)
        check(torch.equal(got, cgtrans.aggregate_edges(relu, *sub,
                                                       impl="kernel")),
              "features='sparse' differs from dense")
        del got, relu, ints
        torch.cuda.empty_cache()
    log(f"  wire bf16 / int8 no-ops unsharded; features='sparse' (capacity "
        f"{cap} of {F}, {GCN_SPARSE_E} edges) bit for bit dense")

    # (d) sharded
    gcn_sharded(torch, dev, launches, smi)

    # (e) times
    cfg, ref_cfg = PALLAS_CONFIG, dataclasses.replace(
        PALLAS_CONFIG, impl="ref", scheduled=None)
    timed = {}
    with torch.no_grad():
        for label in ("kernel", "ref", "ref", "kernel"):
            c = cfg if label == "kernel" else ref_cfg
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gcn_forward_full(params, feats, *edges, c)
            torch.cuda.synchronize()
            timed.setdefault(label, []).append(
                (time.perf_counter() - t0) * 1e3)
        profile_call(torch, lambda: torch.ones(1, device=dev) + 1)  # set-up
        wall, device, hosts, kernels = profile_call(
            torch, lambda: gcn_forward_full(params, feats, *edges, cfg))
        _, launched = counted(torch, K, {k: 0 for k in launches},
                              lambda: gcn_forward_full(params, feats, *edges,
                                                       cfg))
    log(f"  warm gcn_forward_full (add) [{smi}]: kernel "
        + ", ".join(f"{t:.1f}" for t in timed["kernel"]) + " ms, ref "
        + ", ".join(f"{t:.1f}" for t in timed["ref"]) + " ms")
    log(f"  profile of one warm kernel gcn_forward_full (profiler on): wall "
        f"{wall:.1f} ms, device time {device:.2f} ms "
        f"({100 * device / wall:.1f}% busy), GAS launches {launched}; top "
        "host ops (self CPU ms): " + "; ".join(
            f"{k} x{n} {ms:.1f}" for k, n, ms in hosts)
        + "; top device kernels (ms): " + "; ".join(
            f"{k} x{n} {ms:.2f}" for k, n, ms in kernels))
    with torch.no_grad():
        seen = captured_calls(ops, lambda: gcn_forward_full(
            params, feats, *edges, cfg), scheduled=True)
    check(len(seen) == 2, f"{len(seen)} scheduled scatters per forward")
    args, kwargs = seen[0]
    del seen
    out["gas_scatter_banded"] = time_call(
        torch, ops, K, args, kwargs, "layer 0 of gcn_forward_full", smi, 3)
    del args, kwargs
    torch.cuda.empty_cache()
    seen = captured_calls(ops, lambda: gcn_grads(
        torch, lambda p: gcn_forward_full(p, feats, *edges, cfg), params,
        cot), scheduled=False)
    check(len(seen) == 1, f"{len(seen)} unscheduled scatters in fwd+bwd")
    args, kwargs = seen[0]
    del seen
    out["gas_scatter_dense"] = time_call(
        torch, ops, K, args, kwargs, "layer 1's gather backward", smi, 2)
    del args, kwargs, feats, edges
    torch.cuda.empty_cache()
    log(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase a: islandized partitioning, the graph algorithms, the cost model
# ---------------------------------------------------------------------------

ISL_V, ISL_E = 1 << 18, 1 << 22      # the community graph, shuffled ids
ISL_CLUSTERS, ISL_P_INTRA = 64, 0.9
ISL_SHARD_V, ISL_SHARD_E = 1 << 14, 1 << 18
ALG_SCALE, EMB_SCALE, SORT_N = 18, 16, 8192


def shuffled_community_graph(V_, E_, seed=0, n_features=F):
    """``clustered_graph`` with its ids permuted by a seeded permutation
    (``tests/test_partition.py``'s adversary of the interval cut)."""
    import numpy as np

    from repro_torch.graph import COOGraph, clustered_graph

    g = clustered_graph(V_, E_, n_clusters=ISL_CLUSTERS, p_intra=ISL_P_INTRA,
                        seed=seed, n_features=n_features)
    perm = np.random.default_rng(seed + 1000).permutation(V_).astype(
        np.int32)
    return COOGraph(V_, perm[g.src], perm[g.dst], None,
                    g.features[np.argsort(perm)])


def island_rank(mesh, spec):
    """One rank of phase a's sharded part: ``aggregate_edges`` on both
    layouts (integer table, unit weights), and ``sage_forward`` on the
    island layout; each run with the counts set to 0 just before it."""
    import numpy as np
    import torch

    from repro_torch.configs.graphic_gcn import ISLAND_PALLAS_CONFIG
    from repro_torch.core import cgtrans, collectives, gas
    from repro_torch.core.gcn import sage_forward
    from repro_torch.kernels.gas_scatter import kernel as K
    from repro_torch.launch.mesh import host

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, r = mesh.device, mesh.rank
    load = lambda name: torch.from_numpy(np.array(  # noqa
        np.load(os.path.join(spec["dir"], name + ".npy"),
                mmap_mode="r")[r:r + 1])).to(dev)
    out = {"launches": {}, "bytes": {}, "counts": {}, "rows": {}}

    def run(name, fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        with collectives.count_collectives() as c, \
                gas.count_dispatches() as d:
            res = fn()
        torch.cuda.synchronize()
        out["launches"][name] = K.launch_counts()
        out["counts"][name] = {**c.as_dict(),
                               **{k: v for k, v in d.items() if v}}
        out["bytes"][name] = dict(c.bytes)
        out["rows"][name] = host(res)

    with torch.no_grad():
        for layout in ("interval", "island"):
            ints = load(f"{layout}_ints")
            edges = tuple(load(f"{layout}_{k}")
                          for k in ("src", "dst", "w", "mask"))
            for flow in ("cgtrans", "baseline"):
                for op in ("add", "max", "min"):
                    run(f"{layout}/{flow}/{op}",
                        lambda: cgtrans.aggregate_edges(
                            ints, *edges, mesh=mesh, dataflow=flow, op=op,
                            impl="kernel"))
        params = {k: torch.from_numpy(v).to(dev)
                  for k, v in spec["params"].items()}
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in mesh.shard(spec["batch"]).items()}
        run("sage/island", lambda: sage_forward(
            params, load("island_feats"), batch, ISLAND_PALLAS_CONFIG,
            mesh=mesh, relabel=spec["relabel"]))
    out["modules"] = _foreign_modules()
    return out


def island_sharded(torch, dev, launches, smi):
    """Phase a (3): SHARDS gloo ranks on the card at V = 2^14, E = 2^18,
    F = 602: island ≡ interval for both dataflows, the sampled path on
    the island layout against the unsharded port, and the counted
    locality (remote destination rows, bytes per rank)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.common.schema import init_params
    from repro_torch.configs.graphic_gcn import PALLAS_CONFIG
    from repro_torch.core.gcn import feature_table, gcn_schema, sage_forward
    from repro_torch.data import GraphBatchStream, synthetic_node_labels
    from repro_torch.graph import partition_graph, remote_destination_rows
    from repro_torch.launch.mesh import spawn

    g = shuffled_community_graph(ISL_SHARD_V, ISL_SHARD_E, seed=1)
    pg_i, _ = partition_graph(g, SHARDS, method="interval")
    t0 = time.perf_counter()
    pg_s, isl = partition_graph(g, SHARDS, method="island")
    t_isl = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    ints = rng.integers(-8, 9, (ISL_SHARD_V, F)).astype(np.float32)
    part = pg_i.part_size
    arrays = {}
    for layout, pg, order in (("interval", pg_i, None),
                              ("island", pg_s, isl.inverse)):
        rows = ints if order is None else ints[order]
        arrays[f"{layout}_ints"] = rows.reshape(SHARDS, part, F)
        arrays[f"{layout}_feats"] = pg.features
        for k, v in (("src", pg.src), ("dst", pg.dst), ("mask", pg.mask),
                     ("w", np.ones_like(pg.weights))):
            arrays[f"{layout}_{k}"] = v
    labels = synthetic_node_labels(g.features, PALLAS_CONFIG.n_classes,
                                   seed=0)
    batch = GraphBatchStream(g, labels, SHARDS, SHARD_BATCH, k1=FANOUT,
                             k2=FANOUT, seed=0).batch_at(0)
    params = init_params(gcn_schema(PALLAS_CONFIG), 0, device="cpu")
    work = tempfile.mkdtemp(prefix="chip_smoke_island_")
    try:
        for name, arr in arrays.items():
            np.save(os.path.join(work, name + ".npy"), arr)
        spec = {"dir": work, "relabel": isl.relabel, "batch": batch,
                "params": {k: v.numpy() for k, v in params.items()}}
        t0 = time.perf_counter()
        ranks = spawn(island_rank, SHARDS, backend="gloo", device="cuda",
                      timeout_s=SHARD_TIMEOUT_S, args=(spec,))
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  {SHARDS} gloo ranks on one card at V={ISL_SHARD_V}, "
        f"E={ISL_SHARD_E}, F={F} ran in {t_ranks:.1f} s (islandize + "
        f"partition {t_isl:.2f} s on the host)")
    for r, res in enumerate(ranks):
        check(res["modules"] == [], f"rank {r} imported {res['modules']}")
        for name, counts in res["launches"].items():
            check(counts["gas_scatter_banded"] > 0,
                  f"rank {r} {name} never launched gas_scatter_banded")
            for k in counts:
                launches[k] += counts[k]
    relabel = isl.relabel
    for name in ranks[0]["rows"]:
        if not name.startswith("island/"):
            continue
        _, flow, op = name.split("/")
        got = np.concatenate([x["rows"][name] for x in ranks]).reshape(
            SHARDS * part, F)[relabel]
        want = np.concatenate([x["rows"][f"interval/{flow}/{op}"]
                               for x in ranks]).reshape(SHARDS * part, F)
        check(np.array_equal(got, want[:ISL_SHARD_V]),
              f"sharded island {flow}/{op} differs from interval")
    # the sampled path on the island ranks against the unsharded port
    with torch.no_grad():
        tp = {k: v.to(dev) for k, v in params.items()}
        want = sage_forward(tp, feature_table(g.features, SHARDS,
                                              device=dev),
                            batch, PALLAS_CONFIG).cpu().numpy()
    got = np.concatenate([x["rows"]["sage/island"] for x in ranks])
    err = float(np.abs(got - want).max())
    check(np.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"sharded island sage_forward off the unsharded port by {err}")
    rr_i, rr_s = remote_destination_rows(pg_i), remote_destination_rows(pg_s)
    nbytes = {f"{layout}/{flow}/{op}": [x["bytes"][f"{layout}/{flow}/{op}"]
                                        for x in ranks]
              for layout in ("interval", "island")
              for flow in ("cgtrans", "baseline") for op in ("add", "max")}
    log(f"  sharded island ≡ interval bit for bit (cgtrans and baseline x "
        f"add, max, min, un-permuted); island sage_forward within {err:.3g} "
        f"of the unsharded port; remote destination rows per rank interval "
        f"{rr_i.tolist()} (sum {int(rr_i.sum())}) -> island "
        f"{rr_s.tolist()} (sum {int(rr_s.sum())}); e_max interval "
        f"{pg_i.e_max}, island {pg_s.e_max}; bytes per rank: "
        + json.dumps(nbytes))
    return {"remote_rows": {"interval": rr_i.tolist(),
                            "island": rr_s.tolist()},
            "bytes_per_rank": nbytes, "islandize_s": t_isl}


def island_full_graph(torch, K, dev, launches, smi):
    """Phase a (1) and (2) on the shuffled community graph at Reddit width:
    ``gcn_forward_full`` under ``ISLAND_PALLAS_CONFIG`` against
    ``PALLAS_CONFIG``, then ``sage_forward``, one train step and the
    serving engine on both layouts."""
    import numpy as np

    from repro_torch.common.config import TrainConfig
    from repro_torch.common.schema import init_params
    from repro_torch.configs.graphic_gcn import (ISLAND_PALLAS_CONFIG,
                                                 PALLAS_CONFIG)
    from repro_torch.core import cgtrans
    from repro_torch.core.gcn import (feature_table, gcn_forward_full,
                                      gcn_schema, sage_forward)
    from repro_torch.data import GraphBatchStream, synthetic_node_labels
    from repro_torch.graph import partition_graph, remote_destination_rows
    from repro_torch.kernels.gas_scatter import ops
    from repro_torch.launch.serve import replay_traffic
    from repro_torch.optim import adamw_init
    from repro_torch.serving import ServingEngine
    from repro_torch.train import make_sage_train_step

    out = {}
    t0 = time.perf_counter()
    g = shuffled_community_graph(ISL_V, ISL_E, seed=0)
    log(f"  community graph V={ISL_V} E={ISL_E} F={F}, {ISL_CLUSTERS} "
        f"clusters, p_intra {ISL_P_INTRA}, ids shuffled: made in "
        f"{time.perf_counter() - t0:.1f} s")
    pg_i, _ = partition_graph(g, 1, method="interval")
    t0 = time.perf_counter()
    pg_s, isl = partition_graph(g, 1, method="island")
    t_isl = time.perf_counter() - t0
    t0 = time.perf_counter()
    pg4_s, _ = partition_graph(g, SHARDS, method="island")
    t_isl4 = time.perf_counter() - t0
    rr_i = remote_destination_rows(partition_graph(g, SHARDS)[0])
    rr_s = remote_destination_rows(pg4_s)
    del pg4_s
    log(f"  partition_graph(method='island') host seconds (islandize "
        f"dominates): P=1 {t_isl:.2f}, P={SHARDS} {t_isl4:.2f}; "
        f"{isl.n_islands} islands; remote destination rows at P={SHARDS}: "
        f"interval {int(rr_i.sum())} -> island {int(rr_s.sum())} "
        f"(per shard {rr_i.tolist()} -> {rr_s.tolist()})")
    out.update(islandize_s={"P1": t_isl, f"P{SHARDS}": t_isl4},
               remote_rows_full={"interval": rr_i.tolist(),
                                 "island": rr_s.tolist()})

    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    layouts = {}
    for name, pg in (("interval", pg_i), ("island", pg_s)):
        edges = tuple(T(x) for x in (pg.src, pg.dst, pg.weights, pg.mask))
        sched = cgtrans.build_edge_schedule(edges[1], edges[3], ISL_V)
        live, total = ops.schedule_skip_stats(sched)
        dense, _ = ops.dense_skip_stats(edges[1].reshape(-1),
                                        edges[3].reshape(-1), ISL_V)
        layouts[name] = (T(pg.features), edges)
        out.setdefault("work_rows", {})[name] = {
            "banded_live": live, "grid": total, "dense_live": dense}
        del sched
    log(f"  live (row block x edge tile) rounds: {json.dumps(out['work_rows'])}")
    inv = T(isl.inverse).long()
    rl = isl.relabel
    gen = torch.Generator(device=dev).manual_seed(5)
    C = PALLAS_CONFIG.n_classes
    cot = torch.randn((1, ISL_V, C), generator=gen, device=dev)
    schema = gcn_schema(PALLAS_CONFIG)
    nparams = init_params(schema, 0, device=dev)
    iparams = {k: torch.randint(-2, 3, tuple(d.shape), generator=gen,
                                device=dev).to(torch.float32)
               for k, d in schema.items()}
    ints = torch.randint(-2, 3, (1, ISL_V, F), generator=gen,
                         device=dev).to(torch.float32)
    unit = {name: torch.ones_like(e[2]) for name, (_, e) in layouts.items()}

    def fwd(name, op, params, table):
        feats, (src, dst, _, mask) = layouts[name]
        if table is None:
            table = feats
        cfg = dataclasses.replace(
            ISLAND_PALLAS_CONFIG if name == "island" else PALLAS_CONFIG,
            aggregate=op)
        return gcn_forward_full(params, table, src, dst, unit[name], mask,
                                cfg, relabel=rl if name == "island" else None)

    for op in GCN_OPS:
        with torch.no_grad():
            a, ca = counted(torch, K, launches,
                            lambda: fwd("interval", op, iparams, ints))
            b, cb = counted(torch, K, launches,
                            lambda: fwd("island", op, iparams, ints[:, inv]))
            for c in (ca, cb):
                check(c == {"gas_scatter_banded": 2, "gas_scatter_dense": 0},
                      f"{op}: a forward launched {c}")
            check(torch.equal(a, b), f"gcn_forward_full op={op}: island and "
                  f"interval differ on integer data by "
                  f"{float((a - b).abs().max())}")
            mag = float(a.abs().max())
            a = fwd("interval", op, nparams, None)
            b = fwd("island", op, nparams, None)
            err = float((a - b).abs().max())
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
                  f"gcn_forward_full op={op}: island off interval by {err}")
            same = bool(torch.equal(a, b))
            del a, b
        (gi, pi), gc_i = counted(torch, K, launches, lambda: gcn_grads(
            torch, lambda p: fwd("interval", op, p, None), nparams, cot))
        (gs, ps), gc_s = counted(torch, K, launches, lambda: gcn_grads(
            torch, lambda p: fwd("island", op, p, None), nparams, cot))
        want_b = {"gas_scatter_banded": 2 + (op != "add"),
                  "gas_scatter_dense": 1}
        check(gc_i == want_b and gc_s == want_b,
              f"{op}: fwd+bwd launched {gc_i} and {gc_s}")
        # island pre-activations are in island row order: re-pair them
        r_t = T(rl).long()
        flip1, flip2 = flipped_units(pi, [x[:, r_t] for x in ps])
        n_flip = (int(flip1.sum()), int(flip2.sum()))
        if bool(flip2.any()):
            flip1 = torch.ones_like(flip1)
        moved = {"w0": flip1, "b0": flip1, "w1": flip2, "b1": flip2}
        worst = hold_grads(torch, gs, gi, moved, f"island {op}", dev)
        log(f"  gcn_forward_full op={op}: island = interval bit for bit on "
            f"integer data (max |logit| {mag:.4g} < 2^24), normal data "
            f"{'bit for bit' if same else f'within {err:.3g}'}; launches "
            f"forward {cb}, forward + backward {gc_s}; gradients within "
            f"{worst:.3g} of max|g| per leaf (ReLU flips {n_flip})")
        del gi, gs, pi, ps
        torch.cuda.empty_cache()

    # times: warm forwards and the layer-0 banded launch of each layout
    with torch.no_grad():
        for name in ("interval", "island", "island", "interval"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd(name, "add", nparams, None)
            torch.cuda.synchronize()
            out.setdefault("forward_ms", {}).setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
    log(f"  warm gcn_forward_full (add) [{smi}]: "
        + json.dumps(out["forward_ms"]))
    for name in ("interval", "island"):
        with torch.no_grad():
            seen = captured_calls(ops, lambda: fwd(name, "add", nparams,
                                                   None), scheduled=True)
        check(len(seen) == 2, f"{len(seen)} scheduled scatters per forward")
        args, kwargs = seen[0]
        del seen
        out.setdefault("layer0", {})[name] = time_call(
            torch, ops, K, args, kwargs, f"layer 0 of the {name} layout",
            smi, 3, plain=False)
        del args, kwargs
        torch.cuda.empty_cache()

    # (2) the sampled path, the train step and serving on both layouts
    labels = synthetic_node_labels(g.features, C, seed=0)
    stream = GraphBatchStream(g, labels, 1, BATCH, k1=FANOUT, k2=FANOUT,
                              seed=0)
    batch = stream.batch_at(0)
    tables = {"interval": feature_table(g.features, device=dev),
              "island": layouts["island"][0]}
    cfgs = {"interval": (PALLAS_CONFIG, None),
            "island": (ISLAND_PALLAS_CONFIG, rl)}
    for data in ("int", "normal"):
        res = {}
        for name in ("interval", "island"):
            table = tables[name]
            if data == "int":
                table = torch.round(table * 4)
            cfg, relabel = cfgs[name]
            with torch.no_grad():
                res[name], c = counted(torch, K, launches, lambda: sage_forward(
                    nparams, table, batch, cfg, relabel=relabel))
            check(c["gas_scatter_banded"] > 0, f"sage {name} launched {c}")
        err = float((res["island"] - res["interval"]).abs().max())
        if data == "int":
            check(torch.equal(res["island"], res["interval"]),
                  f"sage_forward island differs on integer data by {err}")
        check(torch.allclose(res["island"], res["interval"], rtol=1e-5,
                             atol=1e-5), f"sage_forward island off by {err}")
        log(f"  sage_forward B={BATCH} ({data} data): island vs interval "
            f"max diff {err:.3g}")
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=0, total_steps=1)
    after = {}
    for name in ("interval", "island"):
        cfg, relabel = cfgs[name]
        # a copy each: the step updates its state in place
        start = _tree_clone(nparams)
        state = {"params": start, "opt": adamw_init(start, tc),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step = make_sage_train_step(cfg, tc, feats=tables[name],
                                    relabel=relabel)
        (state, m), c = counted(torch, K, launches,
                                lambda: step(state, batch))
        check(c["gas_scatter_banded"] > 0, f"train {name} launched {c}")
        after[name] = (state["params"], float(m["total_loss"]))
    perr = max(float((after["island"][0][k] - after["interval"][0][k])
                     .abs().max()) for k in nparams)
    check(perr <= 1e-5, f"train step: island params off interval by {perr}")
    log(f"  one make_sage_train_step(relabel=) step: loss "
        f"{after['island'][1]:.6f} (interval {after['interval'][1]:.6f}), "
        f"params within {perr:.3g}")
    del tables, layouts, after
    torch.cuda.empty_cache()
    indptr, indices, _ = g.to_csr()
    for scheduled in (True, False):
        kw = dict(impl="kernel", scheduled=scheduled)
        ref, c_i = counted(torch, K, launches, lambda: serve(
            ServingEngine, replay_traffic, g.features, indptr, indices,
            **kw))
        got, c_s = counted(torch, K, launches, lambda: serve(
            ServingEngine, replay_traffic, g.features, indptr, indices,
            partition="island", **kw))
        kernel = "gas_scatter_banded" if scheduled else "gas_scatter_dense"
        check(c_s[kernel] > 0, f"island serving launched {c_s}")
        compare_serving(ref, got, f"island engine scheduled={scheduled}",
                        against="the interval engine")
        check(all(np.array_equal(ref[r].agg_rows, got[r].agg_rows)
                  for r in ref), f"island serving scheduled={scheduled} "
              "is not bit for bit the interval engine")
    log("  island serving (cache on, banded and dense) bit for bit with the "
        "interval engine")
    return out


def time_round(torch, ops, D, values, V_, op, iters, smi, label):
    """One algorithm round's scatter on the dense grid: CUDA events, the
    profiler's device ms, the function's byte bound ((E ids + E values)
    read, V rows written, 4 bytes each, over HBM) and the library call
    (``scatter_reduce_`` for min, ``torch.sparse.mm`` for add)."""
    call = ops.fused_call(D, values if values.dim() == 2 else values[:, None],
                          None, None, V_, op=op)
    E_, Fv = values.shape[0], (values.shape[1] if values.dim() == 2 else 1)
    t = {"values": list(values.shape), "rows": V_, "op": op,
         "ms": event_ms(torch, call.run, iters, warm=1),
         "device_ms": device_ms(torch, call.run, "dense_cluster_kernel",
                                iters),
         "live_edges": int(call.args[2][-1])}
    nbytes = E_ * 4 + E_ * Fv * 4 + V_ * Fv * 4
    ops_n = E_ * Fv * (2 if op == "add" else 1)
    t["bound_ms"], t["bound_by"] = roofline(nbytes, ops_n)
    if op == "min" and values.dim() == 1:
        out = torch.full((V_,), float("inf"), device=values.device)
        idx = D.long()
        t["library_ms"] = event_ms(torch, lambda: out.scatter_reduce_(
            0, idx, values, "amin", include_self=True), iters, warm=1)
        t["library"] = "scatter_reduce_ amin"
    else:
        t["library_ms"] = event_ms(torch, library_fn(torch, call), iters,
                                   warm=1)
        t["library"] = "torch.sparse.mm"
    log(f"  dense grid at {label} [{smi}]: {json.dumps(t)}")
    return t


def phase_island(torch, K, dev, launches, smi):
    """Phase a: (1, 2) islandized full-graph GCN, sampled path, training
    and serving at Reddit width; (3) the same sharded over SHARDS gloo
    ranks; (4) the graph algorithms on the dense grid; (5) the cost
    model's headline. Returns the measured fields per kernel."""
    import numpy as np

    from repro_torch.core import algorithms as alg
    from repro_torch.core import cost_model, gas
    from repro_torch.graph import rmat
    from repro_torch.kernels.gas_scatter import ops

    t_phase = time.perf_counter()
    full = island_full_graph(torch, K, dev, launches, smi)
    torch.cuda.empty_cache()
    sharded = island_sharded(torch, dev, launches, smi)

    # (4) the algorithms, kernel against ref, bit for bit
    t_alg = time.perf_counter()
    ga = rmat(ALG_SCALE, 16, seed=0, weights=True)
    Va = ga.n_vertices
    S, D, W = (torch.from_numpy(x).to(dev) for x in (ga.src, ga.dst,
                                                     ga.weights))
    runs = {"bfs": lambda impl: alg.bfs(S, D, Va, 0, impl=impl),
            "sssp": lambda impl: alg.sssp(S, D, W, Va, 0, impl=impl),
            "cc": lambda impl: alg.connected_components(S, D, Va, impl=impl)}
    # every round calls the module's gas_scatter once: count the calls
    # (the dispatch counter counts the loop body once, as JAX's does)
    scatters = [0]
    scatter = alg.gas_scatter

    def counting_scatter(*args, **kwargs):
        scatters[0] += 1
        return scatter(*args, **kwargs)

    alg.gas_scatter = counting_scatter
    try:
        rounds, results = {}, {}
        for name, fn in runs.items():
            timed = {}
            for impl in ("kernel", "ref"):
                scatters[0] = 0
                with gas.count_dispatches() as c:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got, lc = counted(torch, K, launches if impl == "kernel"
                                      else {k: 0 for k in launches},
                                      lambda: fn(impl))
                    timed[impl] = (time.perf_counter() - t0) * 1e3
                results[impl] = got
                want = (1, 1 if impl == "kernel" else 0)
                check((c["find"], c["kernel_scatter"]) == want,
                      f"{name} {impl}: dispatches {dict(c)}, JAX counts "
                      f"{want}")
                if impl == "kernel":
                    rounds[name] = scatters[0]
                    check(lc["gas_scatter_dense"] == scatters[0] > 0,
                          f"{name}: {scatters[0]} rounds, launches {lc}")
                else:
                    check(scatters[0] == rounds[name],
                          f"{name}: {scatters[0]} ref rounds, {rounds[name]} "
                          f"kernel rounds")
                    check(lc == {"gas_scatter_banded": 0,
                                 "gas_scatter_dense": 0}, f"{name} ref {lc}")
            check(torch.equal(results["kernel"], results["ref"]),
                  f"{name}: impl=kernel differs from impl=ref")
            reached = int(torch.isfinite(results["kernel"].float()).sum()) \
                if name != "cc" else int(torch.unique(results["kernel"]).numel())
            log(f"  {name} on rmat({ALG_SCALE}, 16): {rounds[name]} rounds, "
                f"kernel {timed['kernel']:.1f} ms ({timed['kernel'] / rounds[name]:.2f}"
                f" ms per round), ref {timed['ref']:.1f} ms; bit for bit; "
                + ("components" if name == "cc" else "reached") + f" {reached}")
            full.setdefault("algorithms", {})[name] = {
                "rounds": rounds[name], "kernel_ms": timed["kernel"],
                "ref_ms": timed["ref"]}
    finally:
        alg.gas_scatter = scatter
    # one round's min scatter, timed alone (sssp's relaxation values)
    dist = alg.sssp(S, D, W, Va, 0, impl="ref")
    relax = (dist[S.long()] + W).contiguous()
    round_t = time_round(torch, ops, D, relax, Va, "min", 5, smi,
                         f"an sssp round (rmat({ALG_SCALE}, 16))")
    t_alg = time.perf_counter() - t_alg
    log(f"  bfs + sssp + cc (kernel and ref) took {t_alg:.1f} s")
    del S, D, W, dist, relax

    # gas_sort and feature_embedding
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        SORT_N).astype(np.float32)).to(dev)
    got, c = counted(torch, K, launches, lambda: alg.gas_sort(x,
                                                              impl="kernel"))
    check(c["gas_scatter_dense"] == 1, f"gas_sort launched {c}")
    check(torch.equal(got, alg.gas_sort(x, impl="ref"))
          and torch.equal(got, torch.sort(x).values), "gas_sort not exact")
    ge = rmat(EMB_SCALE, 16, seed=2)
    rng = np.random.default_rng(6)
    Se, De = (torch.from_numpy(v).to(dev) for v in (ge.src, ge.dst))
    We = torch.from_numpy(rng.integers(-2, 3, ge.n_edges).astype(
        np.float32)).to(dev)
    Fe = torch.from_numpy(rng.integers(-4, 5, (ge.n_vertices, F)).astype(
        np.float32)).to(dev)
    got, c = counted(torch, K, launches, lambda: alg.feature_embedding(
        Se, De, We, Fe, impl="kernel"))
    check(c["gas_scatter_dense"] == 1, f"feature_embedding launched {c}")
    want = alg.feature_embedding(Se, De, We, Fe, impl="ref")
    check(torch.equal(got, want), "feature_embedding: kernel differs from "
          f"ref by {float((got - want).abs().max())}")
    del got, want
    emb_t = time_round(torch, ops, De, (Fe[Se.long()] * We[:, None])
                       .contiguous(), ge.n_vertices, "add", 3, smi,
                       f"feature_embedding (rmat({EMB_SCALE}, 16), F={F})")
    log(f"  gas_sort of {SORT_N} normal draws exact; feature_embedding at "
        f"rmat({EMB_SCALE}, 16), F={F} bit for bit on integer data")
    del Se, De, We, Fe
    torch.cuda.empty_cache()

    # (5) the cost model's headline, as examples/quickstart.py prints it
    rows = cost_model.fig15_table()
    log("  CGTrans vs GCNAX (cost model, Table II datasets):")
    for r in rows:
        log(f"    {r['dataset']:10s} SSD-loading cut "
            f"{r['load_reduction']:.0f}x, speedup vs GCNAX "
            f"{r['speedup_vs_gcnax']:.2f}x, vs Insider "
            f"{r['speedup_vs_insider']:.2f}x")
    log(f"  averages: loading cut "
        f"{np.mean([r['load_reduction'] for r in rows]):.1f}x, vs GCNAX "
        f"{np.mean([r['speedup_vs_gcnax'] for r in rows]):.2f}x, vs Insider "
        f"{np.mean([r['speedup_vs_insider'] for r in rows]):.2f}x")
    log(f"  phase a took {time.perf_counter() - t_phase:.1f} s")
    layer0 = full.pop("layer0")
    return {"gas_scatter_banded": {"island_layer0": layer0,
                                   "island_full_graph": full,
                                   "island_sharded": sharded},
            "gas_scatter_dense": {"algorithm_round_min": round_t,
                                  "feature_embedding_add": emb_t}}


# ---------------------------------------------------------------------------
# phase b: the port's accounting on the card
# ---------------------------------------------------------------------------

ACCOUNTING_TIMEOUT_S = 600


def phase_accounting(torch, launches, smi):
    """Phase b: the H100 spec against the card; the contract registry
    verified on ``contracts.WAYS`` gloo ranks sharing the card with CUDA
    tensors (every contract clean forward and forward + backward, every
    kernel-route contract launching the kernel ``kernel_of`` names on
    every rank); the counted rows of ``BENCH_collective_bytes.json``
    reproduced on the card with zero drift."""
    from repro_torch.analysis import contracts
    from repro_torch.analysis import counted_rows as CR
    from repro_torch.common.hw import H100
    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    props = torch.cuda.get_device_properties(0)
    name = torch.cuda.get_device_name(0)
    check(props.multi_processor_count == H100.sm_count and "H100" in name,
          f"common/hw.py's spec ({H100.name}, {H100.sm_count} SMs) does not "
          f"match the card ({name}, {props.multi_processor_count} SMs)")
    log(f"  spec: {name}, {props.multi_processor_count} SMs, "
        f"{props.total_memory / 2**30:.1f} GiB, matches common/hw.py's "
        f"{H100.name} ({H100.sm_count} SMs) [{smi}]")

    t0 = time.perf_counter()
    ranks = spawn(contracts.verify_rank, contracts.WAYS, backend="gloo",
                  device="cuda", timeout_s=ACCOUNTING_TIMEOUT_S)
    t_verify = time.perf_counter() - t0
    failures = contracts.merge_ranks(ranks)
    check(not failures, "contracts failed on the card: " + json.dumps(
        failures, indent=1))
    n_pass = sum(1 + (c.fwd_bwd is not None)
                 for c in contracts.CONTRACTS.values())
    kernel_route = [n for n in contracts.CONTRACTS
                    if contracts.kernel_of(n)]
    for r, res in enumerate(ranks):
        for n in kernel_route:
            tag = contracts.kernel_pass(n)
            fwd = res["launches"][n][tag]
            k = contracts.kernel_of(n)
            other = ("gas_scatter_dense" if k == "gas_scatter_banded"
                     else "gas_scatter_banded")
            check(fwd[k] > 0 and fwd[other] == 0,
                  f"rank {r} {n}: {tag} launched {fwd}, expected "
                  f"{k} only")
        for per_pass in res["launches"].values():
            for counts in per_pass.values():
                for k, v in counts.items():
                    launches[k] += v
    log(f"  {len(contracts.CONTRACTS)} contracts ({n_pass} passes; "
        f"{len(contracts.WAITING)} waiting) "
        f"clean on {contracts.WAYS} gloo ranks sharing the card in "
        f"{t_verify:.1f} s; each of {len(kernel_route)} kernel-route "
        f"contracts launched its kernel on every rank")

    t0 = time.perf_counter()
    fresh = CR.counted_rows(device="cuda", timeout_s=ACCOUNTING_TIMEOUT_S)
    t_rows = time.perf_counter() - t0
    drift, divergent = CR.compare(fresh, CR.committed())
    check(not drift, f"counted rows drift on the card: {drift}")
    paper = next(r for r in fresh["rows"] if r.get("paper_figure"))
    log(f"  {len(fresh['rows'])} counted rows reproduced on the card in "
        f"{t_rows:.1f} s, zero drift against BENCH_collective_bytes.json "
        f"({len(divergent)} DIVERGENT fields as listed); paper row (K="
        f"{paper['K']}, {paper['ways']} ways): baseline "
        f"{paper['baseline']:.0f} B, cgtrans {paper['cgtrans']:.0f} B, "
        f"ratio {paper['ratio']:.2f}")
    log(f"  phase b took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase d: the sharded LM on a (data 2 x model 2) mesh of gloo ranks
# ---------------------------------------------------------------------------

SHARDED_LM_SHAPE = (2, 2)          # (data, model): 4 gloo ranks, one card
SHARDED_B, SHARDED_S, SHARDED_STEPS = 4, 256, 2
SHARDED_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                  eps=1e-3)
SERVE_B, SERVE_P, SERVE_GEN = 4, 256, 4
SERVE_T = SERVE_P + SERVE_GEN + 2   # the "seq" cache's slots split over model
EMBED_B, EMBED_S = 8, 512
SHARDED_SMOKE = ("deepseek-moe-16b", "llama-3.2-vision-90b")
SHARDED_LM_TIMEOUT_S = 600
# the long-context decode of phase d: gemma2-2b at full width in bf16, B 1
# under long_500k's rule table, its 524,288-slot cache cut to 131,072 (the
# four ranks and the unsharded reference share the card); keys and values
# of positions [0, LONG_FILL) drawn from the seed; two runs of LONG_GEN
# teacher-forced steps, one from LONG_FILL (every model rank's slice holds
# valid positions) and one from LONG_EARLY (model rank 1's holds none)
LONG_ARCH, LONG_T, LONG_FILL, LONG_EARLY, LONG_GEN = (
    "gemma2-2b", 131072, 98304, 4095, 4)
# (run, cache layout, first position) of the bf16 decode; the "heads"
# run (the port's other layout) is the yardstick of bf16 tensor-parallel
# rounding
LONG_RUNS = (("seq_late", "seq", LONG_FILL),
             ("seq_early", "seq", LONG_EARLY),
             ("heads_late", "heads", LONG_FILL))
# the tensor-parallel recurrent mixers of phase d at their published
# widths: f32 and bf16 (flash prefill) serving of B 2 x P 256 and 2 decode
# steps, and one f32 train step of B 4 x S 256 with the kernel-route
# lookup; recurrentgemma-2b's step cut to one pattern block (f32 AdamW
# state of its 2.7 B parameters beside the unsharded reference's does not
# fit the card at full depth)
TP_RECURRENT = ("mamba2-780m", "recurrentgemma-2b")
TP_SERVE_B, TP_SERVE_P, TP_SERVE_GEN = 2, 256, 2
TP_TRAIN_B, TP_TRAIN_S = 4, 256
TP_TRAIN_LAYERS = {"recurrentgemma-2b": 3}
# the f32 decode, where rounding cannot hide a layout fault: a 32,768-slot
# cache (model rank 1's slice starts at 16,384), two steps from each start
LONG_T_F32, LONG_GEN_F32 = 32768, 2
LONG_RUNS_F32 = (("seq_late", "seq", 24576), ("seq_early", "seq",
                                              LONG_EARLY))


def _held_bytes(tree):
    from repro_torch.common.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _grad_check(torch, mesh, cfg, params, specs, batch, full_params,
                impl="ref"):
    """The sharded gradients of one ``loss_fn`` (the train step's own
    reduction; ``impl`` the lookup gradient's backend) gathered, and on
    rank 0 held leaf by leaf against the unsharded port's: (loss, {leaf:
    (max |diff|, max |g|)}) on rank 0."""
    from repro_torch.common.logical import gather_leaf, spec_leaves
    from repro_torch.common.tree import leaves_with_paths, tree_map
    from repro_torch.models import transformer as T
    from repro_torch.train import step as TS

    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    total, _ = T.loss_fn(live, TS._rows(batch, cfg, mesh), cfg, mesh=mesh,
                         impl=impl)
    total.backward()
    grads = TS._sync_grads(tree_map(lambda t: t.grad, live), specs, mesh)
    del live
    spec_of = dict(spec_leaves(specs))
    mine = {p: gather_leaf(g, spec_of[p], mesh)
            for p, g in leaves_with_paths(grads)}
    del grads
    if mesh.rank != 0:
        return float(total.detach()), None
    ref = tree_map(lambda t: t.detach().requires_grad_(True), full_params)
    rtotal, _ = T.loss_fn(ref, batch, cfg)
    rtotal.backward()
    diffs = {p: (float((mine[p] - g.grad).abs().max()),
                 float(g.grad.abs().max()))
             for p, g in leaves_with_paths(ref)}
    return (float(total.detach()), float(rtotal.detach())), diffs


def _long_caches(torch, cfg, mesh, dev, T, start, layout="seq"):
    """The decode caches of ``cfg`` at ``T`` slots in ``layout`` under
    long_500k's rules: (this rank's caches, on rank 0 also
    the unsharded caches, else None). Every layer's keys and values are
    drawn whole from a seed of their own, the slots from ``start`` on
    zeroed where the cache is a full one (a ring's slots all hold valid
    positions), and each rank keeps its sequence slice of the drawn
    tensor, so both hold the same numbers."""
    from repro_torch.common.logical import (local_block, spec_leaves,
                                            tree_to_physical)
    from repro_torch.common.schema import leaves, param_logical_specs
    from repro_torch.launch.specs import LONG_CONTEXT_RULES
    from repro_torch.models import transformer as TT

    schema = TT.stack_cache_schema_for(cfg, 1, T, mesh.shape["model"],
                                       layout)
    phys = dict(spec_leaves(tree_to_physical(param_logical_specs(schema),
                                             mesh, LONG_CONTEXT_RULES)))
    mine, whole = {}, ({} if mesh.rank == 0 else None)
    for i, (path, d) in enumerate(leaves(schema)):
        blocks, fulls = [], []
        for b in range(d.shape[0]):             # the stacked layers
            gen = torch.Generator(device=dev)
            gen.manual_seed(1000 + 64 * i + b)
            t = torch.randn(d.shape[1:], generator=gen, device=dev,
                            dtype=torch.float32).to(d.dtype)
            if d.shape[2] == T:
                t[:, start:] = 0
            blocks.append(local_block(t, phys[path][1:], mesh).clone())
            if whole is not None:
                fulls.append(t)
            del t
        for tree, parts in ((mine, blocks), (whole, fulls)):
            if tree is None:
                continue
            for key in path[:-1]:
                tree = tree.setdefault(key, {})
            tree[path[-1]] = torch.stack(parts)
        del blocks, fulls
    return mine, whole


def _staged_since(before, after):
    """The staged [calls, bytes, seconds] by collective name between two
    ``StagingStats``."""
    out = {}
    for name, (c, b, t) in after.by_name.items():
        c0, b0, t0 = before.by_name.get(name, (0, 0, 0.0))
        if c != c0:
            out[name] = [c - c0, b - b0, t - t0]
    return out


def long_decode_rank(mesh, cfg=None, dtype="bfloat16", T=LONG_T,
                     runs=LONG_RUNS, gen=LONG_GEN):
    """Phase d's long-context decode on this rank: ``cfg`` (default
    ``LONG_ARCH`` at its published width) in ``dtype``, B 1,
    ``LONG_CONTEXT_RULES``, ``T`` cache slots; each run ``(name, layout,
    start)`` decodes ``gen`` teacher-forced tokens from position
    ``start`` with ``cache_layout=layout``, against the unsharded port on
    rank 0: per run the steps' logits differences and scales, ms per
    step, cache bytes, peak memory and the staged collectives by name."""
    import copy

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common.schema import init_params, tree_map_defs
    from repro_torch.core import collectives
    from repro_torch.launch.specs import LONG_CONTEXT_RULES
    from repro_torch.models import transformer as TT
    from repro_torch.train import step as TS

    dev, rank0 = mesh.device, mesh.rank == 0
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = dataclasses.replace(cfg or configs.get_config(LONG_ARCH),
                              compute_dtype=dtype)
    tdt = getattr(torch, dtype)
    schema = tree_map_defs(
        lambda d: dataclasses.replace(d, dtype=tdt)
        if d.dtype == torch.float32 else d, TT.model_schema(cfg))
    # every rank draws each full leaf and keeps its block; rank 0 draws
    # the same numbers whole for the unsharded port
    params = init_params(schema, 3, device=dev, draw="device", mesh=mesh)
    whole = (init_params(schema, 3, device=dev, draw="device") if rank0
             else None)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (1, gen)).astype(np.int32)
    forced = torch.from_numpy(tokens).to(dev)
    out = {}
    for run, layout, start in runs:
        dec = TS.make_decode_step(cfg, mesh=mesh, rules=LONG_CONTEXT_RULES,
                                  cache_layout=layout)
        sync()
        caches, ucaches = _long_caches(torch, cfg, mesh, dev, T, start,
                                       layout)
        cache_bytes = _held_bytes(caches)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        staged0 = copy.deepcopy(mesh.staged)
        mesh.barrier()
        seq, times = [], []
        with torch.no_grad(), collectives.count_collectives() as counted:
            for i in range(gen):
                sync()
                t0 = time.perf_counter()
                logits, caches = dec(params, forced[:, i:i + 1], caches,
                                     start + i)
                sync()
                times.append(time.perf_counter() - t0)
                seq.append(logits.float())
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        lo = mesh.axis_index("model") * (T // mesh.shape["model"])
        res = {"layout": layout, "start": start, "T": T, "dtype": dtype,
               "ms": [1e3 * t for t in times], "cache_bytes": cache_bytes,
               "base": base, "peak": peak,
               "staged": _staged_since(staged0, mesh.staged),
               "counts": dict(counted.calls), "bytes": dict(counted.bytes),
               "finite": all(bool(torch.isfinite(x).all()) for x in seq),
               "model_index": mesh.axis_index("model"),
               "valid_here": layout == "heads" or lo <= start}
        del caches
        if rank0:
            udec = TS.make_decode_step(cfg)
            useq = []
            with torch.no_grad():
                for i in range(gen):
                    ulog, ucaches = udec(whole, forced[:, i:i + 1], ucaches,
                                         start + i)
                    useq.append(ulog.float())
            V = cfg.vocab
            res["diff"] = [(float((a[:, :V] - b[:, :V]).abs().max()),
                            float(b[:, :V].abs().max()),
                            float((a[:, :V] - b[:, :V]).abs().mean()))
                           for a, b in zip(seq, useq)]
            del ucaches, useq
        out[run] = res
        del seq
        if cuda:
            torch.cuda.empty_cache()
        mesh.barrier()
    return out


def _forward_psums(cfg) -> int:
    """``psum`` calls of one sharded forward over ``model``: two per SSD
    layer (its norm's statistic, its ``out_proj``), three per RG-LRU layer
    (the gates, ``w_out``, the MLP's), two per attention layer (the output
    projection, the MLP's), and one for the CGTrans lookup."""
    per = {"ssd": 2, "rglru": 3, "local": 2, "attn": 2}
    return (sum(per[k] for k in cfg.layer_kinds())
            + int(cfg.cgtrans_embedding))


def _cache_bytes_of(cfg, B, T, mesh):
    """The rank's bytes of the decode caches the JAX cache schema places
    (``"seq"``) on ``mesh``."""
    from repro_torch.common.logical import (local_shape, spec_leaves,
                                            tree_to_physical)
    from repro_torch.common.schema import leaves, param_logical_specs
    from repro_torch.models import transformer as TT

    schema = TT.stack_cache_schema_for(cfg, B, T)
    phys = dict(spec_leaves(tree_to_physical(param_logical_specs(schema),
                                             mesh)))
    return sum(math.prod(local_shape(d.shape, phys[p], mesh))
               * d.dtype.itemsize for p, d in leaves(schema))


def _tp_serve(mesh, cfg, params, whole, use_flash, prompt, forced):
    """Prefill and TP_SERVE_GEN teacher-forced decode steps of ``cfg`` on
    the mesh (flash prefill with ``use_flash``), against the unsharded
    port on rank 0: per prefill and step the time, ``psum`` calls,
    staged collectives by name and flash launches; the rank's cache
    bytes; on rank 0 each logits' (max |diff|, max |unsharded|)."""
    import copy

    import torch

    from repro_torch.core import collectives
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.train import step as TS

    dev = mesh.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    T_ = TP_SERVE_P + TP_SERVE_GEN
    pre = TS.make_prefill_step(cfg, cache_len=T_, mesh=mesh,
                               use_flash=use_flash)
    dec = TS.make_decode_step(cfg, mesh=mesh)
    out = {"steps": []}
    seq = []
    with torch.no_grad():
        for i in range(TP_SERVE_GEN + 1):
            staged0 = copy.deepcopy(mesh.staged)
            FK.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            with collectives.count_collectives() as counted:
                if i == 0:
                    logits, caches = pre(params, prompt)
                else:
                    logits, caches = dec(params, forced[:, i - 1:i],
                                         caches, TP_SERVE_P + i - 1)
            sync()
            out["steps"].append({
                "ms": 1e3 * (time.perf_counter() - t0),
                "psum": counted.calls["psum"],
                "counts": counted.as_dict(),
                "staged": _staged_since(staged0, mesh.staged),
                "flash": FK.route_launch_counts(),
                "flash_plain": FK.flash_attention_plain.calls})
            seq.append(logits.float())
        out["cache_bytes"] = _held_bytes(caches)
        out["cache_want"] = _cache_bytes_of(cfg, TP_SERVE_B, T_, mesh)
        out["finite"] = all(bool(torch.isfinite(x).all()) for x in seq)
        del caches
        if whole is not None:
            upre = TS.make_prefill_step(cfg, cache_len=T_,
                                        use_flash=use_flash)
            udec = TS.make_decode_step(cfg)
            ulog, ucache = upre(whole, prompt)
            useq = [ulog.float()]
            for i in range(TP_SERVE_GEN):
                ulog, ucache = udec(whole, forced[:, i:i + 1], ucache,
                                    TP_SERVE_P + i)
                useq.append(ulog.float())
            V = cfg.vocab
            out["diff"] = [(float((a[:, :V] - b[:, :V]).abs().max()),
                            float(b[:, :V].abs().max()))
                           for a, b in zip(seq, useq)]
            del ucache, useq
    return out


def _tp_train(mesh, cfg, tc, batch, state, full):
    """One f32 ``loss_fn`` gradient check and one ``make_train_step``
    step of ``cfg`` with the kernel-route lookup (``impl="kernel"``): the
    gradients against the unsharded port on rank 0, each path's time and
    GAS kernel launches, the step's collectives, staged bytes by name and
    peak memory beside the dry run's trace of this rank."""
    import copy

    import torch

    from repro_torch.common.config import ShapeConfig
    from repro_torch.common.logical import tree_to_physical
    from repro_torch.common.schema import param_logical_specs
    from repro_torch.core import collectives
    from repro_torch.kernels.gas_scatter import kernel as K
    from repro_torch.launch.mesh import TraceMesh
    from repro_torch.models import transformer as T
    from repro_torch.train import step as TS

    dev, cuda = mesh.device, mesh.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    specs = tree_to_physical(param_logical_specs(T.model_schema(cfg)), mesh)
    out = {}
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out["loss_fn"] = _grad_check(torch, mesh, cfg, state["params"], specs,
                                 batch, full, impl="kernel")
    sync()
    out["grad_s"] = time.perf_counter() - t0
    out["grad_launches"] = K.launch_counts()
    del full
    if cuda:
        torch.cuda.empty_cache()
    mesh.barrier()
    step = TS.make_train_step(cfg, tc, mesh=mesh, param_shardings=specs,
                              impl="kernel")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    out["base"] = torch.cuda.memory_allocated(dev) if cuda else 0
    staged0 = copy.deepcopy(mesh.staged)
    K.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    with collectives.count_collectives() as counted:
        state, m = step(state, batch)
    sync()
    out["step_s"] = time.perf_counter() - t0
    out["peak"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    out["step_launches"] = K.launch_counts()
    out["step_counts"] = counted.as_dict()
    out["step_bytes"] = {k: v for k, v in counted.bytes.items() if v}
    out["staged"] = _staged_since(staged0, mesh.staged)
    out["loss"] = float(m["total_loss"])
    del state
    out["pred"] = dry_run_memory(
        cfg, ShapeConfig("chip_d_tp_train", TP_TRAIN_S, TP_TRAIN_B, "train"),
        TraceMesh(mesh.axis_names, mesh.axis_sizes, mesh.rank, dev), tc)
    return out


def recurrent_tp_rank(mesh, smoke=False):
    """Phase d's tensor-parallel recurrent mixers on this rank: for
    mamba2-780m and recurrentgemma-2b at their published widths (``smoke``:
    their CPU-test sizes, for a rehearsal on CPU gloo ranks), f32 and bf16
    serving through ``_tp_serve`` (bf16 with the flash prefill) and one f32
    train step through ``_tp_train``, each against the unsharded port on
    rank 0, every path's kernel counts set to 0 just before it."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.schema import init_params
    from repro_torch.common.tree import tree_map
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.train import step as TS

    dev, rank0 = mesh.device, mesh.rank == 0
    cuda = dev.type == "cuda"
    out = {}
    for arch in TP_RECURRENT:
        cfg = configs.smoke_config(arch) if smoke else \
            configs.get_config(arch)
        c32 = dataclasses.replace(cfg, compute_dtype="float32")
        res = {"layers": cfg.n_layers}
        rng = np.random.default_rng(11)
        prompt = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (TP_SERVE_B, TP_SERVE_P)).astype(np.int32)).to(
                dev)}
        forced = torch.from_numpy(rng.integers(
            0, cfg.vocab, (TP_SERVE_B, TP_SERVE_GEN)).astype(np.int32)).to(
                dev)
        # f32 parameters, each rank's blocks and rank 0's whole tensors
        # drawn from one seed; bf16 serving on their bf16 copies (the
        # serving dtype, half the bytes each ZeRO-3 gather stages)
        schema = T.model_schema(c32)
        params = init_params(schema, 5, device=dev, draw="device", mesh=mesh)
        whole = (init_params(schema, 5, device=dev, draw="device")
                 if rank0 else None)
        t0 = time.perf_counter()
        res["serve_f32"] = _tp_serve(mesh, c32, params, whole, False,
                                     prompt, forced)
        params, whole = (None if t is None else tree_map(
            lambda x: x.to(torch.bfloat16), t) for t in (params, whole))
        res["serve_bf16"] = _tp_serve(mesh, cfg, params, whole, True,
                                      prompt, forced)
        res["serve_s"] = time.perf_counter() - t0
        del params, whole
        if cuda:
            torch.cuda.empty_cache()
        mesh.barrier()
        tcfg = c32
        if not smoke and arch in TP_TRAIN_LAYERS:
            tcfg = dataclasses.replace(c32, n_layers=TP_TRAIN_LAYERS[arch])
        res["train_layers"] = tcfg.n_layers
        tc = TrainConfig(**SHARDED_KW)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenStream(
            vocab=cfg.vocab, batch=TP_TRAIN_B, seq_len=TP_TRAIN_S,
            seed=0).batch_at(0).items()}
        state = TS.init_state(tcfg, tc, 0, mesh=mesh, draw="device")
        full = (init_params(T.model_schema(tcfg), 0, device=dev,
                            draw="device") if rank0 else None)
        t0 = time.perf_counter()
        res["train"] = _tp_train(mesh, tcfg, tc, batch, state, full)
        res["train_s"] = time.perf_counter() - t0
        del state, full
        if cuda:
            torch.cuda.empty_cache()
        mesh.barrier()
        out[arch] = res
    return out


def sharded_lm_rank(mesh, spec):
    """One rank of phase d: full-width qwen1.5-0.5b f32 training (gradients
    against the unsharded port on rank 0, two timed steps), bf16 serving
    with flash prefill, the kernel-route lookup at qwen's width, and two
    smoke architectures; each path with the kernels' launch counts set to
    0 just before it and read just after."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.analysis import contracts
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.logical import (gather_leaf, local_block,
                                            spec_leaves, tree_to_physical)
    from repro_torch.common.schema import init_params, param_logical_specs
    from repro_torch.common.tree import leaves_with_paths, unflatten
    from repro_torch.data import TokenStream
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.gas_scatter import kernel as K
    from repro_torch.launch.counts import count_run
    from repro_torch.models import transformer as T
    from repro_torch.models.embedding import embed_lookup
    from repro_torch.models.layers import _head_split
    from repro_torch.train import step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    rank0 = mesh.rank == 0
    out = {"rank": mesh.rank}
    cfg = configs.get_config(LM_TRAIN_ARCH)
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    tc = TrainConfig(**SHARDED_KW)
    schema = T.model_schema(c32)
    specs = tree_to_physical(param_logical_specs(schema), mesh)
    stream = TokenStream(vocab=cfg.vocab, batch=SHARDED_B,
                         seq_len=SHARDED_S, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(i).items()}
               for i in range(SHARDED_STEPS)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- f32 training: gradients, then two steps --------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = TS.init_state(c32, tc, 0, mesh=mesh, draw="device")
    out["init_peak"] = (torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else 0)
    full = (init_params(schema, 0, device=dev, draw="device") if rank0
            else None)
    out["init_s"] = time.perf_counter() - t0
    out["held"] = (_held_bytes(state["params"]),
                   _held_bytes({k: v for k, v in state["opt"].items()
                                if k in ("m", "v")}))
    t0 = time.perf_counter()
    out["loss_fn"] = _grad_check(torch, mesh, c32, state["params"], specs,
                                 batches[0], full)
    sync()
    out["grad_check_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    mesh.barrier()

    step = TS.make_train_step(c32, tc, mesh=mesh, param_shardings=specs)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out["base"] = (torch.cuda.memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    staged0 = dataclasses.replace(mesh.staged)
    metrics, times = [], []
    for b in batches:
        sync()
        t0 = time.perf_counter()
        state, m = step(state, b)
        sync()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    out["peak"] = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    out["staged"] = (mesh.staged.calls - staged0.calls,
                     mesh.staged.bytes - staged0.bytes,
                     mesh.staged.seconds - staged0.seconds)
    out["steps"], out["step_s"] = metrics, times
    # this rank's step traced by the dry run on a TraceMesh of the same
    # shape and rank
    from repro_torch.common.config import ShapeConfig
    from repro_torch.launch.mesh import TraceMesh
    out["pred"] = dry_run_memory(
        c32, ShapeConfig("chip_d_train", SHARDED_S, SHARDED_B, "train"),
        TraceMesh(mesh.axis_names, mesh.axis_sizes, mesh.rank, dev), tc)
    mesh.barrier()
    if rank0:
        ustate = {"params": full, "opt": TS.adamw_init(full, tc),
                  "step": torch.zeros((), dtype=torch.int32, device=dev)}
        ustep = TS.make_train_step(c32, tc)
        um, ut = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            ustate, m = ustep(ustate, b)
            sync()
            ut.append(time.perf_counter() - t0)
            um.append({k: float(v) for k, v in m.items()})
        out["unsharded"] = (um, ut)
        del ustate, full
    torch.cuda.empty_cache()
    mesh.barrier()

    # -- bf16 serving, prefill through flash on the local heads ----------
    params = state["params"]
    del state
    rng = np.random.default_rng(1)
    prompt = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_P)).astype(np.int32)).to(dev)}
    forced = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_GEN)).astype(np.int32)).to(dev)
    pre = TS.make_prefill_step(cfg, cache_len=SERVE_T,
                               mesh=mesh, use_flash=True)
    dec = TS.make_decode_step(cfg, mesh=mesh)
    with torch.no_grad():
        sync()
        FK.reset_launch_counts()
        plain0 = FK.flash_attention_plain.calls
        t0 = time.perf_counter()
        logits, caches = pre(params, prompt)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["flash"] = (FK.launch_counts()["flash_attention"],
                        FK.route_launch_counts(),
                        FK.flash_attention_plain.calls - plain0)
        seq = [logits.float()]
        t0 = time.perf_counter()
        for i in range(SERVE_GEN):
            logits, caches = dec(params, forced[:, i:i + 1], caches,
                                 SERVE_P + i)
            seq.append(logits.float())
        sync()
        out["decode_s"] = (time.perf_counter() - t0) / SERVE_GEN
        spec_of = dict(spec_leaves(specs))
        whole = unflatten(params, [gather_leaf(p, spec_of[path], mesh)
                                   for path, p in leaves_with_paths(params)])
        if rank0:
            upre = TS.make_prefill_step(cfg, cache_len=SERVE_T)
            udec = TS.make_decode_step(cfg)
            FK.reset_launch_counts()
            ulog, ucache = upre(whole, prompt)
            useq = [ulog.float()]
            for i in range(SERVE_GEN):
                ulog, ucache = udec(whole, forced[:, i:i + 1], ucache,
                                    SERVE_P + i)
                useq.append(ulog.float())
            V = cfg.vocab
            out["serve"] = [(float((a[:, :V] - b[:, :V]).abs().max()),
                             float(b[:, :V].abs().max()))
                            for a, b in zip(seq, useq)]
            del ucache, useq
        del whole, caches, seq

    # -- the flash kernel at this rank's prefill shape -------------------
    # (after the counted run: these launches do not count)
    tp, q_split, kv_split = _head_split(cfg, mesh)
    H = cfg.n_heads // tp if q_split else cfg.n_heads
    Hkv = cfg.n_kv_heads // tp if kv_split else cfg.n_kv_heads
    rows = SERVE_B // mesh.shape["data"]
    args = flash_inputs(torch, FK, rows, SERVE_P, SERVE_P, H, Hkv, cfg.hd,
                        torch.bfloat16, seed=mesh.rank)
    kw = dict(causal=True, window=0, softcap=cfg.attn_logit_softcap,
              kv_len=SERVE_P, n_kv_heads=Hkv)
    FK.reset_launch_counts()
    got = FK.flash_attention_fwd(*args, **kw)
    launched = FK.route_launch_counts()
    want = FK.flash_attention_plain(*args, **kw)
    sync()
    got, want = got[:, :SERVE_P].float(), want[:, :SERVE_P].float()
    out["flash_check"] = {
        "shape": (rows, H, Hkv, SERVE_P, cfg.hd), "routes": launched,
        "ok": bool(torch.isfinite(got).all()) and bool(torch.allclose(
            got, want, **FLASH_TOL["bfloat16"])),
        "max_abs_err": float((got - want).abs().max())}
    del args, got, want
    torch.cuda.empty_cache()
    mesh.barrier()

    # -- the kernel-route lookup at qwen's width -------------------------
    m24 = mesh
    V, D = cfg.vocab_padded, cfg.d_model
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    table = torch.randint(-4, 5, (V, D), generator=gen, device=dev).float()
    ids = torch.randint(0, V, (EMBED_B, EMBED_S), generator=gen, device=dev,
                        dtype=torch.int32)
    cot_int = torch.randint(-2, 3, (EMBED_B, EMBED_S, D), generator=gen,
                            device=dev).float()
    cot_normal = torch.randn((EMBED_B, EMBED_S, D), generator=gen,
                             device=dev)
    tab = local_block(table, ("model", None), m24).contiguous()
    mine = local_block(ids, ("data", None), m24).contiguous()
    del table
    runs = {}
    for impl in ("kernel", "ref"):
        for name, cot in (("int", cot_int), ("normal", cot_normal)):
            c = local_block(cot, ("data", None, None), m24)
            t = tab.clone().requires_grad_(True)
            sync()
            K.reset_launch_counts()
            run = count_run(lambda a, b: embed_lookup(
                a, b, mesh=m24, impl=impl, compute_dtype=torch.float32)
                * c, t, mine, fwd_bwd=True)
            sync()
            runs[(impl, name)] = (run.as_dict(), K.launch_counts())
            del run
    fwd = count_run(lambda a, b: embed_lookup(
        a, b, mesh=m24, impl="kernel", compute_dtype=torch.float32),
        tab, mine)
    out["embed_counts"] = {"forward": fwd.as_dict(), "runs": runs}
    del fwd
    # the table gradient of each route: sum(lookup · cot) scatters cot
    embed_grads = {}
    for impl in ("kernel", "ref"):
        for name, cot in (("int", cot_int), ("normal", cot_normal)):
            c = local_block(cot, ("data", None, None), m24)
            t = tab.clone().requires_grad_(True)
            (embed_lookup(t, mine, mesh=m24, impl=impl,
                          compute_dtype=torch.float32) * c).sum().backward()
            embed_grads[(impl, name)] = t.grad
    out["embed"] = {
        "int_equal": bool(torch.equal(embed_grads[("kernel", "int")],
                                      embed_grads[("ref", "int")])),
        "normal": _close(embed_grads[("kernel", "normal")],
                         embed_grads[("ref", "normal")], 1e-5, 1e-5),
        "budget": {impl: (dict(contracts.CONTRACTS[
            f"embed_lookup/cgtrans/{jax_name}"].forward),
            dict(contracts.CONTRACTS[
                f"embed_lookup/cgtrans/{jax_name}"].fwd_bwd))
            for impl, jax_name in (("kernel", "pallas"), ("ref", "xla"))}}
    del embed_grads, tab, cot_int, cot_normal
    torch.cuda.empty_cache()
    mesh.barrier()

    # -- two smoke architectures: one sharded step each ------------------
    stc = TrainConfig(**SMOKE_KW)
    out["smoke"] = {}
    for arch in SHARDED_SMOKE:
        c = configs.smoke_config(arch)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in TokenStream(
            vocab=c.vocab, batch=SMOKE_B * 2, seq_len=16,
            with_vision=c.vision_seq, d_model=c.d_model).batch_at(0).items()}
        sstate = TS.init_state(c, stc, 0, mesh=mesh)
        sspecs = tree_to_physical(param_logical_specs(T.model_schema(c)),
                                  mesh)
        sstate, m = TS.make_train_step(c, stc, mesh=mesh)(sstate, tb)
        spec_of = dict(spec_leaves(sspecs))
        got = {p: gather_leaf(v, spec_of[p], mesh)
               for p, v in leaves_with_paths(sstate["params"])}
        if rank0:
            ustate = TS.init_state(c, stc, 0, device=dev)
            ustate, um = TS.make_train_step(c, stc)(ustate, tb)
            worst = max(float((got[p] - v).abs().max())
                        for p, v in leaves_with_paths(ustate["params"]))
            out["smoke"][arch] = (float(m["total_loss"]),
                                  float(um["total_loss"]), worst)
    del sstate, got
    torch.cuda.empty_cache()
    mesh.barrier()

    # -- tensor-parallel SSD and RG-LRU at their published widths -------
    t0 = time.perf_counter()
    out["tp_recurrent"] = recurrent_tp_rank(mesh)
    out["tp_recurrent_s"] = time.perf_counter() - t0

    # -- long-context decode: gemma2-2b under long_500k's rules ----------
    t0 = time.perf_counter()
    out["long"] = {"bfloat16": long_decode_rank(mesh),
                   "float32": long_decode_rank(
                       mesh, dtype="float32", T=LONG_T_F32,
                       runs=LONG_RUNS_F32, gen=LONG_GEN_F32)}
    out["long_s"] = time.perf_counter() - t0
    out["staged_total"] = dataclasses.asdict(mesh.staged)
    return out


def _embed_dense_timing(torch, K, smi, arch=LM_TRAIN_ARCH, batch=EMBED_B,
                        seq=EMBED_S):
    """The owner-side dense launch of the kernel-route lookup at
    ``arch``'s width, on one rank's inputs (data rank 0's batch/2 x seq
    ids, model rank 0's vocab half): CUDA events, the profiler's device
    ms, the plain version, ``torch.index_add`` (the library yardstick) and
    the bytes bound."""
    from repro_torch import configs
    from repro_torch.core import gas
    from repro_torch.kernels.gas_scatter import ops

    cfg = configs.get_config(arch)
    V, D = cfg.vocab_padded, cfg.d_model
    shard = V // SHARDED_LM_SHAPE[1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ids = torch.randint(0, V, (batch // SHARDED_LM_SHAPE[0], seq),
                        generator=gen, device="cuda").reshape(-1)
    g = torch.randn((ids.numel(), D), generator=gen, device="cuda")
    ok = ids < shard
    rel = torch.where(ok, ids, 0).to(torch.int32)
    ones = torch.ones(ids.numel(), device="cuda")
    calls = captured_calls(ops, lambda: gas.gas_scatter_weighted(
        rel, g, ones, ok, shard, op="add", impl="kernel"), scheduled=False)
    check(len(calls) == 1, f"the lookup's gradient made {len(calls)} "
          f"kernel calls, expected 1")
    call = ops.fused_call(*calls[0][0], **calls[0][1])
    got = call.run()
    want = plain_in_order(torch, call)
    ok_, d = _close(got, want, 1e-5, 1e-5)
    check(ok_, f"the lookup's dense launch off its plain version by {d}")
    # the library call computes the same function: a fresh (rows, D)
    # gradient, the owned cotangent rows added in (out of place, so every
    # call writes the whole output, as the kernel does)
    zeros = torch.zeros((shard, D), device="cuda")
    live = torch.nonzero(ok)[:, 0]
    lid, lg = rel[live].long(), g[live]
    check(torch.allclose(torch.index_add(zeros, 0, lid, lg), want[:shard, :D],
                         rtol=1e-5, atol=1e-5),
          "index_add differs from the lookup's dense launch")
    t = {"tokens": int(ids.numel()), "owned": int(live.numel()),
         "rows": shard, "width": D,
         "ms": event_ms(torch, call.run, 50, warm=3),
         "device_ms": device_ms(torch, call.run,
                                KERNEL_SYMBOL["gas_scatter_dense"], 50),
         "plain_ms": event_ms(torch, call.run_plain, 10, warm=1),
         "library_ms": event_ms(
             torch, lambda: torch.index_add(zeros, 0, lid, lg), 50, warm=3),
         "live_edges": int(call.args[2][-1]),
         "max_abs_err": d}
    t["bound_ms"], t["bound_by"] = bound(call)
    log(f"  gas_scatter_dense at the lookup's gradient ({arch} width, one "
        f"rank: {t['tokens']} tokens, {t['owned']} owned, {shard} x {D} "
        f"rows) [{smi}]: {json.dumps(t)}")
    return t


def _tp_flash_check(torch, FK, smi):
    """``flash_mma_kernel`` against its plain version at the shape
    recurrentgemma-2b's local layers give it on a rank of the bf16
    sharded prefill (its rows, the rank's 5 q heads, the one kv head
    picked for each, window 2048), timed beside the plain version, SDPA
    and the bound."""
    from repro_torch import configs
    from repro_torch.models.layers import _splits

    cfg = configs.get_config("recurrentgemma-2b")
    tp = SHARDED_LM_SHAPE[1]
    q_split, kv_split = _splits(cfg, tp)
    check(q_split and not kv_split, f"recurrentgemma-2b on {tp} model "
          f"ranks: q split {q_split}, kv split {kv_split}")
    rows, H, S_ = TP_SERVE_B // SHARDED_LM_SHAPE[0], cfg.n_heads // tp, \
        TP_SERVE_P
    args = flash_inputs(torch, FK, rows, S_, S_, H, H, cfg.hd,
                        torch.bfloat16, seed=3)
    kw = dict(causal=True, window=cfg.window,
              softcap=cfg.attn_logit_softcap, kv_len=S_, n_kv_heads=H)
    FK.reset_launch_counts()
    got = FK.flash_attention_fwd(*args, **kw)
    routes = FK.route_launch_counts()
    want = FK.flash_attention_plain(*args, **kw)
    got, want = got[:, :S_].float(), want[:, :S_].float()
    err = float((got - want).abs().max())
    check(routes == {"mma_bf16": 1, "fma_f32": 0}, f"the flash check at "
          f"recurrentgemma's sharded prefill shape launched {routes}")
    check(bool(torch.isfinite(got).all()) and bool(torch.allclose(
        got, want, **FLASH_TOL["bfloat16"])), f"flash_mma_kernel at "
        f"recurrentgemma's sharded prefill shape off its plain version by "
        f"{err} (tolerance {FLASH_TOL['bfloat16']})")
    q, k, v = (t.reshape(rows, H, -1, cfg.hd)[:, :, :S_] for t in args)
    mask = torch.ones(S_, S_, dtype=torch.bool, device="cuda").tril()
    mask &= ~torch.ones_like(mask).tril(-cfg.window)
    t = {"shape": [rows, H, H, S_, cfg.hd], "max_abs_err": err,
         "ms": event_ms(torch, lambda: FK.flash_attention_fwd(*args, **kw),
                        20),
         "plain_ms": event_ms(torch, lambda: FK.flash_attention_plain(
             *args, **kw), 3, warm=1),
         "library_ms": event_ms(torch, lambda: torch.nn.functional.
                                scaled_dot_product_attention(
                                    q, k, v, attn_mask=mask, scale=1.0), 20)}
    t["bound_ms"], t["bound_by"], _, _ = flash_bound(
        S_, S_, H, H, rows, cfg.hd, kw, 2)
    log(f"  flash_mma_kernel at recurrentgemma-2b's sharded local-layer "
        f"prefill shape (rows, q heads, kv heads, S, hd) {t['shape']}, "
        f"causal, window {cfg.window} [{smi}]: {json.dumps(t)}")
    return t


def check_tp_recurrent(ranks, launches, measured, smi):
    """Phase d's tensor-parallel SSD and RG-LRU. Serving: f32 logits
    within 1e-4 of the largest unsharded logit, bf16 logits finite (their
    distance printed); every forward's ``psum`` calls those of its layers
    (``_forward_psums``); each rank's caches the bytes the JAX cache schema
    places on it; the bf16 prefill's flash launches one per local layer on
    ``mma_bf16``, no plain call. Training: the loss within 1e-5 and every
    gradient leaf within 1e-4 of its max |g| of the unsharded port; the
    kernel-route lookup's dense launches one per forward + backward where
    the config's lookup is CGTrans; each rank's step peak within ±10 % of
    its dry-run trace."""
    from repro_torch import configs
    by_route = measured.setdefault("flash_attention", {}).setdefault(
        "launches_by_route", {})
    for arch in TP_RECURRENT:
        cfg = configs.get_config(arch)
        r0 = ranks[0]["tp_recurrent"][arch]
        n_local = sum(k == "local" for k in cfg.layer_kinds())
        for mode in ("serve_f32", "serve_bf16"):
            c = dataclasses.replace(cfg, compute_dtype="float32") \
                if mode == "serve_f32" else cfg
            want_psum = _forward_psums(c)
            for r in ranks:
                res = r["tp_recurrent"][arch][mode]
                check(res["finite"], f"{arch} {mode}: rank {r['rank']}'s "
                      f"logits are not finite")
                check(res["cache_bytes"] == res["cache_want"],
                      f"{arch} {mode}: rank {r['rank']} holds "
                      f"{res['cache_bytes']} B of caches, the JAX schema "
                      f"places {res['cache_want']}")
                for i, st in enumerate(res["steps"]):
                    check(st["psum"] == want_psum, f"{arch} {mode} step "
                          f"{i}: rank {r['rank']} counted {st['psum']} "
                          f"psum, expected {want_psum}")
                    n = st["flash"]["mma_bf16"] + st["flash"]["fma_f32"]
                    want_n = n_local if (mode == "serve_bf16" and i == 0) \
                        else 0
                    check(n == st["flash"]["mma_bf16"] == want_n
                          and st["flash_plain"] == 0,
                          f"{arch} {mode} step {i}: rank {r['rank']} "
                          f"launched flash {st['flash']}, "
                          f"{st['flash_plain']} plain calls; expected "
                          f"{want_n} on mma_bf16")
                    launches["flash_attention"] += n
                    for route, k in st["flash"].items():
                        by_route[route] = by_route.get(route, 0) + k
            diff = r0[mode]["diff"]
            scale = max(sc for _, sc in diff)
            if mode == "serve_f32":
                check(all(d <= 1e-4 * scale for d, _ in diff),
                      f"{arch} f32 sharded logits off the unsharded port "
                      f"by {diff} (limit {1e-4 * scale:.3g})")
            st0 = r0[mode]["steps"]
            log(f"  {arch} {mode[6:]} serving at full width (B "
                f"{TP_SERVE_B}, prompt {TP_SERVE_P}, {TP_SERVE_GEN} decode "
                f"steps, {'flash' if mode == 'serve_bf16' else 'plain'} "
                f"prefill): logits max |sharded - unsharded| "
                + ", ".join(f"{d:.4g}" for d, _ in diff)
                + f" of up to {scale:.1f} ({max(d for d, _ in diff) / scale:.3g} "
                f"of it); psum per layer and forward "
                f"{st0[0]['psum']}/{cfg.n_layers}; rank 0 cache "
                f"{r0[mode]['cache_bytes'] / 1e9:.4f} GB; flash launches per "
                f"rank {[r['tp_recurrent'][arch][mode]['steps'][0]['flash'] for r in ranks][0]} [{smi}]")
            for r in ranks:
                res = r["tp_recurrent"][arch][mode]
                log(f"    rank {r['rank']}: ms prefill, steps "
                    + ", ".join(f"{st['ms']:.1f}" for st in res["steps"])
                    + "; staged by name [calls, bytes, s] per prefill / "
                    "step: " + " | ".join(json.dumps(
                        {k: [c_, b_, round(t_, 4)] for k, (c_, b_, t_)
                         in sorted(st["staged"].items())})
                        for st in res["steps"]))
        tr0 = r0["train"]
        (loss_sh, loss_un), diffs = tr0["loss_fn"]
        check(abs(loss_sh - loss_un) <= 1e-5 * abs(loss_un),
              f"{arch} sharded f32 loss {loss_sh} against unsharded "
              f"{loss_un}")
        g_max = max(m for _, m in diffs.values())
        worst, worst_leaf = 0.0, None
        for path, (d, m) in diffs.items():
            scale = g_max if path[-1] == "bk" else m
            check(d <= 1e-4 * scale, f"{arch} f32 gradient "
                  f"{'/'.join(map(str, path))} off the unsharded port by "
                  f"{d} (max |g| {m})")
            if path[-1] != "bk" and d / max(m, 1e-30) > worst:
                worst, worst_leaf = d / max(m, 1e-30), path
        dense = int(cfg.cgtrans_embedding)
        for r in ranks:
            tr = r["tp_recurrent"][arch]["train"]
            for what in ("grad_launches", "step_launches"):
                kl = tr[what]
                check(kl == {"gas_scatter_banded": 0,
                             "gas_scatter_dense": dense},
                      f"{arch} train ({what}): rank {r['rank']} launched "
                      f"{kl}, expected {dense} dense")
                launches["gas_scatter_dense"] += kl["gas_scatter_dense"]
            hold_peak(f"rank {r['rank']} {arch} sharded f32 step "
                      f"({r['tp_recurrent'][arch]['train_layers']} layers, "
                      f"B {TP_TRAIN_B}, S {TP_TRAIN_S}, impl='kernel')",
                      tr["peak"], tr["base"], tr["pred"], smi)
        log(f"  {arch} f32 training at full width "
            f"({r0['train_layers']} of {cfg.n_layers} layers), B "
            f"{TP_TRAIN_B}, S {TP_TRAIN_S}, impl='kernel': loss sharded "
            f"{loss_sh:.6f} / unsharded {loss_un:.6f}; {len(diffs)} "
            f"gradient leaves within 1e-4 of their max |g| (worst "
            f"{worst:.3g} at {'/'.join(map(str, worst_leaf))}); dense "
            f"launches per rank {dense} per fwd+bwd; grad check "
            f"{tr0['grad_s']:.2f} s, step {tr0['step_s']:.2f} s on rank 0; "
            f"step collectives {tr0['step_counts']} (psum per layer "
            f"{tr0['step_counts'].get('psum', 0) / r0['train_layers']:.2f}) "
            f"[{smi}]")
        for r in ranks:
            tr = r["tp_recurrent"][arch]["train"]
            log(f"    rank {r['rank']}: step {1e3 * tr['step_s']:.1f} ms, "
                f"staged by name [calls, bytes, s] " + json.dumps(
                    {k: [c_, b_, round(t_, 4)] for k, (c_, b_, t_)
                     in sorted(tr["staged"].items())}))
    log(f"  tensor-parallel recurrent section took "
        f"{ranks[0]['tp_recurrent_s']:.1f} s on rank 0")


def check_long_decode(ranks, smi, cfg=None):
    """Phase d's long-context decode. Every run: logits finite on every
    rank; the decode's collectives per step and layer; model rank 1's
    slice without a valid position in the early runs. f32: within 2e-2
    of the largest unsharded logit on rank 0. bf16: the ``"seq"`` layout
    no further from the unsharded port than 1.5 times the ``"heads"``
    layout's distance on the same run (the tensor-parallel rounding both
    share: row-parallel partial products round to bf16 before their
    psum). Per rank ms/step, cache bytes, peak memory and the staged
    collectives by name printed."""
    from repro_torch import configs
    cfg = cfg or configs.get_config(LONG_ARCH)
    n_full = sum(k == "attn" for k in cfg.layer_kinds())
    r0 = ranks[0]
    for dtype, runs in r0["long"].items():
        for run, res0 in runs.items():
            seq = res0["layout"] == "seq"
            gen = len(res0["ms"])
            want = ({"decode_qkv_gather": cfg.n_layers * gen,
                     "decode_max": n_full * gen,
                     "decode_sum": n_full * gen} if seq else
                    {"decode_qkv_gather": 0, "decode_max": 0,
                     "decode_sum": 0})
            label = (f"long decode ({dtype}, {res0['layout']}, from "
                     f"{res0['start']})")
            for r in ranks:
                res = r["long"][dtype][run]
                check(res["finite"], f"{label}: rank {r['rank']}'s logits "
                      f"are not finite")
                got = {k: res["counts"].get(k, 0) for k in want}
                check(got == want and "result_gather" not in res["counts"],
                      f"{label}: rank {r['rank']} counted {res['counts']}, "
                      f"expected {want} and no row gather")
                early = res["start"] < res["T"] // 2
                check(res["valid_here"] == (not (seq and early)
                                            or res["model_index"] == 0),
                      f"{label}: rank {r['rank']} (model index "
                      f"{res['model_index']}) valid-slice flag "
                      f"{res['valid_here']}")
            diff = res0["diff"]
            worst = max(d for d, _, _ in diff)
            scale = max(sc for _, sc, _ in diff)
            if dtype == "float32":
                check(all(d <= 2e-2 * sc for d, sc, _ in diff),
                      f"{label}: logits off the unsharded port by {diff}")
            elif seq:
                yard = max(d for d, _, _ in runs["heads_late"]["diff"])
                check(worst <= 1.5 * yard, f"{label}: logits off the "
                      f"unsharded port by {worst}, over 1.5 times the "
                      f"heads layout's {yard}")
            log(f"  long-context decode, {LONG_ARCH} at full width, {dtype}, "
                f"B 1, long_500k's rules, cache_layout='{res0['layout']}', "
                f"{res0['T']} slots (cut from 524288), positions "
                f"{res0['start']}..{res0['start'] + gen - 1}: logits "
                f"max |sharded - unsharded| "
                + ", ".join(f"{d:.4g}" for d, _, _ in diff)
                + f" (mean " + ", ".join(f"{m:.3g}" for _, _, m in diff)
                + f") of up to {scale:.1f} ({worst / scale:.3g} of it); "
                f"decode collectives over the {gen} steps {want}")
            for r in ranks:
                res = r["long"][dtype][run]
                log(f"    rank {r['rank']} (model {res['model_index']}, "
                    f"{'a' if res['valid_here'] else 'no'} valid slot in "
                    f"its cache) [{smi}]: ms/step "
                    + ", ".join(f"{t:.1f}" for t in res["ms"])
                    + f"; cache {res['cache_bytes'] / 1e9:.4f} GB; peak "
                    f"{res['peak'] / 2**30:.3f} GiB "
                    f"({res['base'] / 2**30:.3f} GiB at the reset); staged "
                    f"by name [calls, bytes, s]: "
                    + json.dumps({k: [c, b, round(t, 4)] for k, (c, b, t)
                                  in sorted(res["staged"].items())}))
    log(f"  long-context decode took {r0['long_s']:.1f} s on rank 0")


def phase_sharded_lm(torch, FK, K, launches, measured, smi):
    """Phase d: the sharded LM on 4 gloo ranks sharing the card."""
    from repro_torch import configs
    from repro_torch.common.schema import count_params, leaves
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = configs.get_config(LM_TRAIN_ARCH)
    n_params = count_params(T.model_schema(cfg))
    t0 = time.perf_counter()
    ranks = spawn(sharded_lm_rank, SHARDED_LM_SHAPE, backend="gloo",
                  device="cuda", timeout_s=SHARDED_LM_TIMEOUT_S,
                  args=({},))
    log(f"  {len(ranks)} gloo ranks on one card, mesh {SHARDED_LM_SHAPE} "
        f"(data, model), ran in {time.perf_counter() - t0:.1f} s")
    r0 = ranks[0]

    (loss_sh, loss_un), diffs = r0["loss_fn"]
    check(abs(loss_sh - loss_un) <= 1e-5 * abs(loss_un),
          f"sharded f32 loss {loss_sh} against unsharded {loss_un}")
    # the key bias's gradient is zero up to rounding (softmax is
    # shift-invariant): held against the largest gradient, every other
    # leaf against its own largest
    g_max = max(m for _, m in diffs.values())
    worst, worst_leaf = 0.0, None
    for path, (d, m) in diffs.items():
        scale = g_max if path[-1] == "bk" else m
        check(d <= 1e-4 * scale, f"f32 gradient {'/'.join(map(str, path))}"
              f" off the unsharded port by {d} (max |g| {m})")
        if path[-1] != "bk" and d / max(m, 1e-30) > worst:
            worst, worst_leaf = d / max(m, 1e-30), path
    log(f"  qwen1.5-0.5b f32 at full width ({n_params / 1e6:.1f} M params),"
        f" B {SHARDED_B}, S {SHARDED_S}: sharded loss {loss_sh:.6f}, "
        f"unsharded {loss_un:.6f}; {len(diffs)} gradient leaves within "
        f"1e-4 of their max |g| (worst {worst:.3g} at "
        f"{'/'.join(map(str, worst_leaf))}; key biases against the largest "
        f"gradient {g_max:.3g})")
    um, ut = r0["unsharded"]
    for i, (m, u) in enumerate(zip(r0["steps"], um)):
        rtol = 1e-5 if i == 0 else 1e-4
        check(abs(m["total_loss"] - u["total_loss"]) <= rtol * abs(
            u["total_loss"]), f"sharded step {i + 1} loss "
            f"{m['total_loss']} against unsharded {u['total_loss']}")
    for r in ranks:
        check([m["total_loss"] for m in r["steps"]] ==
              [m["total_loss"] for m in r0["steps"]],
              f"rank {r['rank']}'s losses differ from rank 0's")
    unsharded_state = 3 * n_params * 4
    # init draws each full leaf and keeps the rank's block before the next
    # draw: the peak is the rank's state plus a few full leaves (the draw
    # and its temporaries), never the whole model
    biggest = max(4 * math.prod(d.shape)
                  for _, d in leaves(T.model_schema(cfg)))
    for r in ranks:
        hold_peak(f"rank {r['rank']} sharded f32 step (B {SHARDED_B}, S "
                  f"{SHARDED_S}, mesh {SHARDED_LM_SHAPE})", r["peak"],
                  r["base"], r["pred"], smi)
    for r in ranks:
        p_b, o_b = r["held"]
        check(r["init_peak"] <= p_b + o_b + 3 * biggest,
              f"rank {r['rank']}: init peaked at {r['init_peak']} bytes, "
              f"over its state {p_b + o_b} plus three of the largest leaf "
              f"({biggest})")
        calls, nbytes, secs = r["staged"]
        log(f"  rank {r['rank']} [{smi}]: steps "
            + ", ".join(f"{1e3 * t:.1f}" for t in r["step_s"])
            + f" ms; init peak {r['init_peak'] / 2**30:.2f} GiB (largest "
            f"leaf {biggest / 2**30:.2f} GiB); step peak memory "
            f"{r['peak'] / 2**30:.2f} GiB; holds "
            f"{(p_b + o_b) / 1e9:.3f} GB of parameters and AdamW moments "
            f"({100 * (p_b + o_b) / unsharded_state:.1f}% of the unsharded "
            f"{unsharded_state / 1e9:.3f} GB); staged over the two steps: "
            f"{calls} calls, {nbytes / 1e9:.3f} GB, {secs:.2f} s")
    log(f"  losses: sharded "
        + ", ".join(f"{m['total_loss']:.6f}" for m in r0["steps"])
        + ", unsharded " + ", ".join(f"{m['total_loss']:.6f}" for m in um)
        + f"; warm step (step 2): sharded {1e3 * r0['step_s'][-1]:.1f} ms "
        f"(4 ranks on one card, gloo staged), unsharded "
        f"{1e3 * ut[-1]:.1f} ms [{smi}]")

    n_flash, routes, plain = r0["flash"]
    by_route = measured.setdefault("flash_attention", {}).setdefault(
        "launches_by_route", {})
    for r in ranks:
        n, rts, pl = r["flash"]
        check(n == cfg.n_layers and rts.get("mma_bf16", 0) == n and pl == 0,
              f"rank {r['rank']}: sharded prefill launched flash {n} times "
              f"({rts}), {pl} plain calls; expected {cfg.n_layers} on "
              f"mma_bf16")
        launches["flash_attention"] += n
        for route, k in rts.items():
            by_route[route] = by_route.get(route, 0) + k
        fc = r["flash_check"]
        check(fc["routes"] == {"mma_bf16": 1, "fma_f32": 0},
              f"rank {r['rank']}: the flash check at the prefill shape "
              f"launched {fc['routes']}")
        check(fc["ok"], f"rank {r['rank']}: flash_mma_kernel at the sharded "
              f"prefill shape {fc['shape']} off its plain version by "
              f"{fc['max_abs_err']} (tolerance {FLASH_TOL['bfloat16']})")
    fc_err = max(r["flash_check"]["max_abs_err"] for r in ranks)
    measured["flash_attention"]["sharded_prefill"] = {
        "shape": list(r0["flash_check"]["shape"]), "max_abs_err": fc_err}
    log(f"  flash_mma_kernel at each rank's prefill shape (rows, heads, kv "
        f"heads, S, hd) {r0['flash_check']['shape']}, causal, bf16: max |"
        f"kernel - plain| {fc_err:.3g} over the ranks (tolerance "
        f"{FLASH_TOL['bfloat16']})")
    for i, (d, scale) in enumerate(r0["serve"]):
        check(d <= 2e-2 * scale, f"bf16 sharded "
              f"{'prefill' if i == 0 else f'decode step {i}'} logits off "
              f"the unsharded port by {d} (limit {2e-2 * scale:.3g})")
    log(f"  bf16 serving (B {SERVE_B}, prompt {SERVE_P}, {SERVE_GEN} decode "
        f"steps): flash launches per rank "
        f"{[r['flash'][0] for r in ranks]}, all on mma_bf16 "
        f"({routes}); logits max |sharded - unsharded| "
        + ", ".join(f"{d:.3g}" for d, _ in r0["serve"])
        + f" of up to {max(s for _, s in r0['serve']):.1f}; prefill "
        f"{1e3 * r0['prefill_s']:.1f} ms, decode "
        f"{1e3 * r0['decode_s']:.1f} ms/step [{smi}]")

    fwd_budget, bwd_budget = r0["embed"]["budget"]["kernel"]
    for r in ranks:
        e = r["embed"]
        check(e["int_equal"], f"rank {r['rank']}: kernel-route table "
              f"gradient not bit for bit impl=ref on integer data")
        check(e["normal"][0], f"rank {r['rank']}: kernel-route table "
              f"gradient off impl=ref by {e['normal'][1]}")
        check(r["embed_counts"]["forward"] == fwd_budget,
              f"rank {r['rank']}: lookup forward counted "
              f"{r['embed_counts']['forward']}, budget {fwd_budget}")
        for (impl, name), (counts, kl) in r["embed_counts"]["runs"].items():
            budget = r0["embed"]["budget"][impl][1]
            check(counts == budget, f"rank {r['rank']}: lookup impl={impl} "
                  f"fwd+bwd counted {counts}, budget {budget}")
            if impl == "kernel":
                check(kl["gas_scatter_dense"] == 1 and
                      kl["gas_scatter_banded"] == 0,
                      f"rank {r['rank']}: the kernel-route gradient "
                      f"launched {kl}")
                launches["gas_scatter_dense"] += kl["gas_scatter_dense"]
            else:
                check(sum(kl.values()) == 0, f"rank {r['rank']}: impl=ref "
                      f"launched {kl}")
    log(f"  embed_lookup(impl='kernel') at qwen's width (V {cfg.vocab_padded},"
        f" D {cfg.d_model}, ids {EMBED_B} x {EMBED_S}): counts "
        f"{bwd_budget} forward + backward = the contract's; one dense launch"
        f" per rank per gradient; table gradient bit for bit impl=ref on "
        f"integer data, max |diff| {r0['embed']['normal'][1]:.3g} on normal "
        f"data")

    for arch, (l, ul, d) in r0["smoke"].items():
        check(abs(l - ul) <= 1e-5 * abs(ul) and d <= 1e-5,
              f"{arch} smoke: sharded loss {l} against {ul}, parameters "
              f"off by {d}")
        log(f"  {arch} (smoke) one sharded step: loss {l:.6f} / unsharded "
            f"{ul:.6f}, parameters max |diff| {d:.3g}")
    check_tp_recurrent(ranks, launches, measured, smi)
    check_long_decode(ranks, smi)
    torch.cuda.empty_cache()
    timing = _embed_dense_timing(torch, K, smi)
    measured.setdefault("gas_scatter_dense", {})[
        "embed_grad_recurrentgemma"] = _embed_dense_timing(
            torch, K, smi, "recurrentgemma-2b", TP_TRAIN_B, TP_TRAIN_S)
    measured["flash_attention"]["sharded_recurrent_prefill"] = \
        _tp_flash_check(torch, FK, smi)
    log(f"  phase d took {time.perf_counter() - t_phase:.1f} s")
    return timing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="123456789abcd",
                    help="the phases to run, as characters 1-9 and a-d "
                    "(default: all)")
    phases = set(ap.parse_args(argv).phases)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.gas_scatter import kernel as K

    smi = smi_line()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("phase 1: build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda m: m.build(), (K, FK)))
    log(f"  built {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"  ptxas: {line.strip()}")

    measured, launches = {}, {name: 0 for name in REPLACES}
    if phases & set("23478"):
        graph_phases(torch, phases, dev, measured, launches, smi)
    if "5" in phases:
        log("phase 5: flash attention against its plain version")
        measured.update(phase_flash(torch, FK, smi))
    if "6" in phases:
        log("phase 6: whisper-base serving at full width")
        launches["flash_attention"], routes = phase_lm(torch, FK, smi)
        measured.setdefault("flash_attention", {})[
            "launches_by_route"] = routes
    if "9" in phases:
        log("phase 9: full-graph GCN at Reddit width, unsharded and over "
            f"{SHARDS} ranks")
        for name, t in phase_gcn(torch, K, dev, launches, smi).items():
            measured.setdefault(name, {})["gcn_full_graph"] = t
    if "a" in phases:
        log("phase a: islandized partitioning at Reddit width, unsharded and "
            f"over {SHARDS} ranks; the graph algorithms; the cost model")
        for name, t in phase_island(torch, K, dev, launches, smi).items():
            measured.setdefault(name, {}).update(t)
    if "b" in phases:
        log("phase b: the accounting — contracts, dtype rules and counted "
            "rows on the card")
        phase_accounting(torch, launches, smi)
    if "c" in phases:
        log(f"phase c: LM training at full width ({LM_TRAIN_ARCH}), the "
            "recurrent kinds at their published widths, seven "
            "architectures at smoke size")
        phase_lm_train(torch, FK, K, smi)
    if "d" in phases:
        log(f"phase d: the sharded LM ({LM_TRAIN_ARCH} at full width) on a "
            f"(data {SHARDED_LM_SHAPE[0]} x model {SHARDED_LM_SHAPE[1]}) "
            f"mesh of gloo ranks sharing the card")
        measured.setdefault("gas_scatter_dense", {})["embed_grad"] = \
            phase_sharded_lm(torch, FK, K, launches, measured, smi)

    kernels = []
    for name, entry in measured.items():
        kernels.append({"name": name, "route": "cuda", "source": CSRC[name],
                        "replaces": REPLACES[name],
                        "launches": launches[name], **entry})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
