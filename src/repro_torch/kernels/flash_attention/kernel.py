"""Blocked flash attention: the Hopper kernel's wrapper, beside its plain version.

The kernel lives in ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``;
the source note there says which TPU kernel it replaces, what bounds it
and how it is laid out). It is compiled with ``nvcc`` into a shared
library with a plain C interface the first time the wrapper launches on a
CUDA tensor, and loaded with ``ctypes``. Nothing is built when this module
is imported.

``flash_attention_fwd`` takes the arguments of the Pallas entry it
replaces and dispatches on where its tensors lie:

* CUDA tensors launch the kernel on PyTorch's current stream (and add one
  to ``flash_attention_fwd.launches`` and to its route's count); a refused
  launch raises. The route follows the dtype (``flash_plan``): bfloat16
  runs ``flash_mma_kernel`` on the tensor cores, float32 runs
  ``flash_fwd_kernel`` on the CUDA cores, whose full f32 products keep the
  1e-5 agreement with the plain version. The binding is lean: the plan is
  cached per (dtype, head dim), the C entry is resolved once and the
  stream comes from PyTorch's raw query;
* CPU tensors run ``flash_attention_plain``, the same blocked walk in
  PyTorch;
* anything else raises, a fake tensor first of all
  (``entries.refuse_fake``). There is no fallback from the kernel to the
  plain version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, entries

NEG_INF = -2.3819763e38
BLOCK_Q = 128
BLOCK_K = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "fma_f32", torch.bfloat16: "mma_bf16"}
_HEAD_PADS = (16, 32, 64, 128, 256)
_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# (C entry, stream query), resolved at the first launch
_entries: Optional[tuple] = None
_PLANS: dict = {}


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` unless this source's library
    exists (``kernels._build``). Returns the library path."""
    return _build.build(_SOURCE)


def _load() -> tuple:
    """(C entry, stream query), built and bound at first use."""
    global _lib, _entries
    with _lib_lock:
        if _entries is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            fn = lib.flash_attention_fwd
            fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i,
                           ctypes.c_float, i, i, i, i, p]
            fn.restype = i
            # the raw handle of PyTorch's current stream on a device index,
            # far cheaper than torch.cuda.current_stream()
            _lib, _entries = lib, (fn, torch._C._cuda_getCurrentRawStream)
    return _entries


class FlashPlan(NamedTuple):
    """How the kernel runs one call: the route, the head dim padded to a
    template instance, query rows and keys per CTA tile, threads per CTA
    and the CTA's dynamic shared memory in bytes. The CUDA side refuses a
    plan it does not build."""
    route: str
    head_pad: int
    block_q: int
    block_k: int
    threads: int
    smem_bytes: int


def flash_plan(dtype: torch.dtype, hd: int) -> FlashPlan:
    """The launch plan for ``dtype`` inputs of head dim ``hd``.

    ``mma_bf16``: 4 warps × 16 query rows; bf16 q tile plus a two-stage
    ring of k and v sub-tiles (64 keys, 32 at head pad 256), each shared
    row padded by 8 elements. ``fma_f32``: a 64-row query tile, each warp
    owning 16 of its rows (4 warps; 8 rows and 8 warps at head pad 256);
    the f32 q tile plus a two-stage ring of k and v sub-tiles (64 keys, 32
    at head pad 128 and 256), rows padded by 4 floats, and each warp's own
    p slice (one row of ``rows + 4`` floats per key). Shared bytes depend
    on the head pad alone. Plans are cached per (dtype, hd).
    """
    key = (dtype, hd)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _make_plan(dtype, hd)
    return plan


def _make_plan(dtype: torch.dtype, hd: int) -> FlashPlan:
    if dtype not in ROUTES:
        raise TypeError(f"no flash route for {dtype}")
    if hd % 8 or not 0 < hd <= 256:
        raise ValueError(f"head dim {hd} must be a multiple of 8 up to 256")
    pad = next(p for p in _HEAD_PADS if hd <= p)
    if ROUTES[dtype] == "mma_bf16":
        bq, bk, stages = 64, (32 if pad == 256 else 64), 2
        smem = 2 * (bq + 2 * stages * bk) * (pad + 8)
        return FlashPlan("mma_bf16", pad, bq, bk, 128, smem)
    rows = 8 if pad == 256 else 16            # query rows per warp
    bq, bk, stages = 64, (32 if pad >= 128 else 64), 2
    warps = bq // rows
    smem = 4 * ((bq + 2 * stages * bk) * (pad + 4) + warps * bk * (rows + 4))
    return FlashPlan("fma_f32", pad, bq, bk, 32 * warps, smem)


def _check(q, k, v, kv_len: int, n_kv_heads: int):
    """(H, G): query heads per batch row and query heads per kv head."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be (B·H, S, hd) and k, v (B·Hkv, T, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, hd = q.shape
    BKV, T, hdk = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if S % BLOCK_Q or T % BLOCK_K:
        raise ValueError(f"S={S} and T={T} must be multiples of {BLOCK_Q}")
    if hdk != hd or hd % 8 or not 0 < hd <= 256:
        raise ValueError(f"head dim {hd} (k: {hdk}) must be a multiple of 8 "
                         f"up to 256")
    if n_kv_heads < 1 or BKV % n_kv_heads:
        raise ValueError(f"{BKV} kv rows do not split into {n_kv_heads} "
                         f"heads")
    batch = BKV // n_kv_heads
    if BH % batch or (BH // batch) % n_kv_heads:
        raise ValueError(f"{BH} query rows do not group over {batch} batch "
                         f"rows of {n_kv_heads} kv heads")
    if not 0 <= kv_len <= T:
        raise ValueError(f"kv_len={kv_len} outside [0, {T}]")
    H = BH // batch
    return H, H // n_kv_heads


def flash_attention_plain(q, k, v, *, causal: bool, window: int,
                          softcap: float, kv_len: int, n_kv_heads: int):
    """Plain PyTorch version of the kernel: the TPU kernel's blocked
    online-softmax walk, 128 × 128 blocks, the same band skip and the same
    finite ``NEG_INF``, one vectorised step per kv block over every
    (bh, q block) at once. Arguments as in ``flash_attention_fwd``."""
    flash_attention_plain.calls += 1
    H, G = _check(q, k, v, kv_len, n_kv_heads)
    BH, S, hd = q.shape
    T = k.shape[1]
    dev = q.device
    bh = torch.arange(BH, device=dev)
    kv_rows = (bh // H) * n_kv_heads + (bh % H) // G
    nq = S // BLOCK_Q
    qb = q.reshape(BH, nq, BLOCK_Q, hd).float()
    q_start = torch.arange(nq) * BLOCK_Q          # on the host: the band skip
    qpos = (q_start[:, None] + torch.arange(BLOCK_Q)).to(dev)[:, :, None]
    neg = torch.tensor(NEG_INF, device=dev)
    m = torch.full((BH, nq, BLOCK_Q), NEG_INF, device=dev)
    l = torch.zeros((BH, nq, BLOCK_Q), device=dev)
    acc = torch.zeros((BH, nq, BLOCK_Q, hd), device=dev)
    for k_start in range(0, T, BLOCK_K):
        visible = torch.ones(nq, dtype=torch.bool)
        if causal:
            visible &= k_start <= q_start + BLOCK_Q - 1
        if window:
            visible &= k_start + BLOCK_K - 1 > q_start - window
        if not bool(visible.any()):
            continue
        visible = visible.to(dev)
        kt = k[kv_rows, k_start:k_start + BLOCK_K].float()
        vt = v[kv_rows, k_start:k_start + BLOCK_K]
        s = torch.einsum("bnqd,bkd->bnqk", qb, kt)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kpos = k_start + torch.arange(BLOCK_K, device=dev)
        ok = (kpos < kv_len).expand(nq, BLOCK_Q, BLOCK_K)
        if causal:
            ok = ok & (qpos >= kpos)
        if window:
            ok = ok & (qpos - kpos < window)
        s = torch.where(ok, s, neg)
        m_cur = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l_new = l * alpha + p.sum(-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bnqk,bkd->bnqd", p.to(v.dtype).float(), vt.float())
        vis = visible[None, :, None]
        m = torch.where(vis, m_cur, m)
        l = torch.where(vis, l_new, l)
        acc = torch.where(vis[..., None], acc_new, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(BH, S, hd).to(q.dtype)


def flash_attention_fwd(q, k, v, *, causal: bool, window: int,
                        softcap: float, kv_len: int, n_kv_heads: int):
    """Blocked attention, forward only. q: (B·H, S, hd) pre-scaled; k, v:
    (B·Hkv, T, hd); heads flattened b-major, h-minor, and query head h of
    batch row b reads kv head ``b·Hkv + h // (H/Hkv)``. S and T multiples
    of 128; keys at ``kv_len`` and past it are padding. float32 or bfloat16
    in, float32 statistics and accumulator, out in q's dtype."""
    entries.refuse_fake("flash_attention_fwd", q, k, v)
    H, _ = _check(q, k, v, kv_len, n_kv_heads)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"no kernel for device {q.device}")
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, kv_len=kv_len,
                                     n_kv_heads=n_kv_heads)
    index = q.get_device()
    if k.get_device() != index or v.get_device() != index:
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("kernel inputs must be 16-byte aligned")
    BH, S, hd = q.shape
    plan = flash_plan(q.dtype, hd)
    out = q.new_empty(q.shape)
    if BH == 0:
        return out
    entry, stream = _entries or _load()
    rc = entry(_DTYPES[q.dtype], qp, kp, vp, out.data_ptr(), BH, S,
               k.shape[1], hd, H, n_kv_heads, int(causal), int(window),
               float(softcap), kv_len, plan.head_pad, plan.block_k,
               plan.smem_bytes, stream(index))
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed ({plan}): "
                           f"CUDA error {rc}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.route_launches[plan.route] += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.route_launches = {r: 0 for r in ROUTES.values()}
flash_attention_plain.calls = 0


def reset_launch_counts() -> None:
    """Set the kernel's launch counts (all and per route) and the plain
    version's call count to 0."""
    flash_attention_fwd.launches = 0
    for r in flash_attention_fwd.route_launches:
        flash_attention_fwd.route_launches[r] = 0
    flash_attention_plain.calls = 0


def launch_counts() -> dict:
    return {"flash_attention": flash_attention_fwd.launches}


def route_launch_counts() -> dict:
    """Launches per route since the last reset: ``mma_bf16`` and
    ``fma_f32``."""
    return dict(flash_attention_fwd.route_launches)
