"""Port parity: the production dry run (``repro_torch.launch.dryrun``).

* **Argument bytes**, every cell of ``configs.cells()`` on the (16, 16)
  and (2, 16, 16) meshes: the port's rank-0 bytes of the parameters,
  optimiser state and batch rows equal the JAX dry run's ``_arg_bytes``
  formula (``src/repro/launch/dryrun.py:99-109``) over JAX's own schemas,
  logical specs, ``to_physical`` on a stand-in mesh and
  ``specs.rules_for``. The serving cases' caches take the JAX layout
  (``cache_layout="seq"``): their bytes equal the JAX formula's in every
  cell, the recurrent layers' states too (the rank's heads and channels).
  The port's other layout (``"heads"``: the rank's rows and every slot of
  the kv heads its attention reads; a recurrent state as in ``"seq"``) is
  held to its own formula.
* **Trace ≡ real run** on 4 gloo ranks as (data 2 × model 2): rank r's
  fake trace of reduced qwen1.5-0.5b's train and decode steps and of one
  reduced deepseek-moe-16b train step gives exactly the real run's
  collective calls and bytes per name, dot FLOPs, HBM bytes and peak.
* **FLOPs against JAX**: reduced qwen1.5-0.5b, gemma2-2b and whisper-base,
  unsharded, train and prefill: the traced dot FLOPs within 1e-2 of
  ``repro.launch.hlo_analysis.analyze(...).dot_flops`` of the JAX step
  compiled here on its one CPU device. One SSD and one RG-LRU layer at
  their published widths, traced on rank 0 of the (16, 16) mesh: the
  dot FLOPs of the unsharded layer with every head- or width-split
  product divided by 16.
* Two production traces with a complete record (qwen1.5-0.5b ×
  decode_32k and gemma2-2b × long_500k under its rule table, both on
  (16, 16)), the CLI's ``--list`` against JAX's, ``launch.train
  --dry-run``, and the kernel wrappers refusing fake tensors.

The ranks import ``torch`` and ``repro_torch`` only (this module imports
JAX inside the tests that need it).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.common.config import ShapeConfig, TrainConfig
from repro_torch.launch import dryrun, specs, trace_analysis
from repro_torch.launch import mesh as meshlib

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s, mp) for a, s in configs.cells() for mp in (False, True)]
TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# argument and cache bytes against the JAX formula
# ---------------------------------------------------------------------------

class _StandIn:
    """A JAX-mesh stand-in: the axis names and sizes ``to_physical`` and
    ``_arg_bytes`` read."""

    def __init__(self, multi_pod):
        shape, names = meshlib.PRODUCTION_SHAPES[multi_pod]
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _jax_bytes(structs, logical, mesh, rules):
    """The JAX dry run's ``_arg_bytes`` summed over a tree: each struct's
    bytes divided by the mesh sizes of the axes of its PartitionSpec."""
    import jax

    from repro.common.logical import to_physical
    is_spec = lambda x: isinstance(x, tuple)  # noqa: E731
    total = 0.0
    for st, spec in zip(jax.tree.leaves(structs),
                        jax.tree.leaves(logical, is_leaf=is_spec)):
        div = 1
        for entry in to_physical(spec, mesh, rules):
            for ax in ((entry,) if isinstance(entry, str)
                       else (entry or ())):
                div *= mesh.shape[ax]
        total += int(np.prod(st.shape)) * st.dtype.itemsize / div
    return total


def _jax_case_bytes(arch, shape_name, multi_pod):
    """(bytes of the parameters / state and batch, bytes of the caches)
    per device in the JAX dry run's layout."""
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.common.config import TrainConfig as JTrainConfig
    from repro.common.schema import (param_logical_specs, param_structs,
                                     tree_map_defs)
    from repro.launch.specs import TRAIN_MICROBATCHES, rules_for
    from repro.train import step as JS

    cfg, shape = jconfigs.get_config(arch), jconfigs.get_shape(shape_name)
    mesh, rules = _StandIn(multi_pod), rules_for(shape)
    max_seq = shape.seq_len if cfg.is_encoder_decoder else 0
    if shape.kind == "train":
        tc = JTrainConfig(microbatches=TRAIN_MICROBATCHES.get(arch, 1))
        schema = JS.state_schema(cfg, tc, max_seq=max_seq)
        return (_jax_bytes(param_structs(schema),
                           param_logical_specs(schema), mesh, rules)
                + _jax_bytes(JS.batch_structs(cfg, shape),
                             JS.batch_logical_specs(cfg), mesh, rules), 0.0)
    bf16 = tree_map_defs(
        lambda d: dataclasses.replace(d, dtype=jnp.bfloat16)
        if d.dtype == jnp.float32 else d,
        JS.T.model_schema(cfg, max_seq=max_seq))
    args = _jax_bytes(param_structs(bf16), param_logical_specs(bf16), mesh,
                      rules)
    tok, caches, _ = JS.decode_structs(cfg, shape)
    tok_spec, cache_spec, _ = JS.decode_logical_specs(cfg, shape)
    if shape.kind == "prefill":
        bs, spec = JS.batch_structs(cfg, shape), JS.batch_logical_specs(cfg)
        bs.pop("labels")
        spec.pop("labels")
        args += _jax_bytes(bs, spec, mesh, rules)
    else:
        args += _jax_bytes(tok, tok_spec, mesh, rules)
    return args, _jax_bytes(caches, cache_spec, mesh, rules)


def _layout_bytes(cfg, shape, multi_pod, layout):
    """The rank's bytes of the caches in ``layout`` on a production mesh
    under the shape's rules."""
    from repro_torch.common.logical import (local_shape, spec_leaves,
                                            tree_to_physical)
    from repro_torch.common.tree import leaves_with_paths
    from repro_torch.train import step as TS
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    tp = mesh.shape["model"]
    _, spec, _ = TS.decode_logical_specs(cfg, shape, tp, layout=layout)
    _, structs, _ = TS.decode_structs(cfg, shape, tp, layout=layout)
    phys = dict(spec_leaves(tree_to_physical(spec, mesh,
                                             specs.rules_for(shape))))
    return sum(math.prod(local_shape(tuple(t.shape), phys[p], mesh))
               * t.element_size()
               for p, t in leaves_with_paths(structs))


def _port_cache_bytes(cfg, shape, multi_pod):
    """The rank's caches in the port's ``"heads"`` layout, from the layer
    kinds: its B/dp rows (all of them under long_500k's rules); an
    attention cache's window or sequence slots and its kv heads split over
    ``model`` where they divide, else one per q head where those divide,
    else all; a recurrent state's heads and channels split over ``model``
    (the SSD's B and C convs whole)."""
    from repro_torch.models import ssm
    from repro_torch.models.transformer import stack_layout
    dims, names = meshlib.PRODUCTION_SHAPES[multi_pod]
    size = dict(zip(names, dims))
    tp = size["model"]
    dp = 1 if shape.name == "long_500k" else size["data"] * size.get("pod", 1)
    rows, S = shape.global_batch // dp, shape.seq_len
    item = 2 if cfg.compute_dtype == "bfloat16" else 4
    hd = cfg.hd
    if cfg.n_kv_heads % tp == 0:
        heads = cfg.n_kv_heads // tp
    elif cfg.n_heads % tp == 0:
        heads = cfg.n_heads // tp
    else:
        heads = cfg.n_kv_heads

    def kv(T):
        return 2 * rows * T * heads * hd * item

    lay = stack_layout(cfg)
    kinds = (list(lay.prefix) + list(lay.pattern) * lay.n_blocks
             + list(lay.suffix))
    total = 0
    for kind in kinds:
        if kind in ("attn", "moe"):
            total += kv(S)
        elif kind == "local":
            total += kv(cfg.window if cfg.window and cfg.window < S else S)
        elif kind == "cross":
            total += kv(cfg.vision_seq)
        elif kind == "dec":
            total += kv(S) + kv(cfg.enc_seq)
        elif kind == "ssd":
            d_inner, H, P_, N = ssm.dims(cfg)
            K = cfg.conv_kernel
            total += rows * 4 * ((H * P_ * N + (K - 1) * d_inner) // tp
                                 + (K - 1) * 2 * N)
        elif kind == "rglru":
            W = cfg.lru_width or cfg.d_model
            total += rows * 4 * W * cfg.conv_kernel // tp
    return total


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'multi' if m else 'single'}"
                              for a, s, m in CELLS])
def test_arg_bytes_equal_the_jax_formula(arch, shape, multi_pod,
                                         record_property):
    cfg, shp = configs.get_config(arch), configs.get_shape(shape)
    case = specs.build_case(cfg, shp, meshlib.make_production_mesh(
        multi_pod=multi_pod))
    want_args, jax_caches = _jax_case_bytes(arch, shape, multi_pod)
    held = case.arg_bytes - (case.cache_bytes if shp.kind == "decode" else 0)
    assert held == want_args
    if shp.kind == "train":
        assert case.cache_bytes == 0
    else:
        assert case.cache_bytes == jax_caches > 0
        assert _layout_bytes(cfg, shp, multi_pod, "heads") == \
            _port_cache_bytes(cfg, shp, multi_pod) > 0
    record_property("cache_bytes_port", case.cache_bytes)
    record_property("cache_bytes_jax_layout", jax_caches)


def test_every_parameter_splits_on_both_meshes():
    from repro_torch.common.logical import (local_shape, spec_leaves,
                                            tree_to_physical)
    from repro_torch.common.schema import leaves, param_logical_specs
    from repro_torch.models import transformer as T
    for arch in configs.ARCHS:
        schema = T.model_schema(configs.get_config(arch))
        for mp in (False, True):
            mesh = meshlib.make_production_mesh(multi_pod=mp)
            phys = tree_to_physical(param_logical_specs(schema), mesh)
            for (_, spec), (_, d) in zip(spec_leaves(phys), leaves(schema)):
                local_shape(d.shape, spec, mesh)   # raises on a ragged split


# ---------------------------------------------------------------------------
# a fake trace equals a real run, rank by rank
# ---------------------------------------------------------------------------

TRACE_CASES = (("qwen_train", "qwen1.5-0.5b", "train"),
               ("qwen_decode", "qwen1.5-0.5b", "decode"),
               ("moe_train", "deepseek-moe-16b", "train"))
TRACE_B, TRACE_S = 4, 16


def _real(fake, vocab, seed):
    """Real tensors of the fake arguments' shapes and dtypes: floats small
    and random, integers random ids below ``vocab``."""
    from repro_torch.common.tree import tree_map
    gen = torch.Generator().manual_seed(seed)

    def make(t):
        if not torch.is_tensor(t):
            return t
        if t.is_floating_point():
            return (0.02 * torch.randn(t.shape, generator=gen)).to(t.dtype)
        return torch.randint(0, vocab, t.shape, generator=gen,
                             dtype=t.dtype)
    return tree_map(make, fake)


def _summary(s):
    return {"collectives": s.collectives, "dot_flops": s.dot_flops,
            "hbm_bytes": s.hbm_bytes, "peak_bytes": s.peak_bytes,
            "args_bytes": s.args_bytes}


def _trace_rank(mesh):
    out = {}
    trace = meshlib.TraceMesh(mesh.axis_names, mesh.axis_sizes, mesh.rank,
                              mesh.device)
    for name, arch, kind in TRACE_CASES:
        cfg = configs.smoke_config(arch)
        shape = ShapeConfig(name, TRACE_S, TRACE_B, kind)
        tc = TrainConfig()
        fake = specs.build_case(cfg, shape, trace, tc, device="cpu")
        with fake.fake_mode:
            traced = trace_analysis.analyze(fake.fn, *fake.args)
        case = specs.build_case(cfg, shape, mesh, tc, device="cpu")
        real = trace_analysis.analyze(case.fn,
                                      *_real(case.args, cfg.vocab, mesh.rank))
        out[name] = (_summary(traced), _summary(real))
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


@pytest.fixture(scope="module")
def traced_ranks():
    return meshlib.spawn(_trace_rank, (2, 2), backend="gloo", device="cpu",
                         timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("name", [c[0] for c in TRACE_CASES])
def test_fake_trace_equals_the_real_run(traced_ranks, name):
    for r in traced_ranks:
        traced, real = r[name]
        # A meta kernel may give a size-1 dimension another stride than
        # the CPU kernel, and matmul then folds to mm where the other run
        # takes bmm: the same FLOPs, other eager bytes. HBM bytes are an
        # upper bound; they are held within 5 %, the rest exactly.
        assert math.isclose(traced.pop("hbm_bytes"), real.pop("hbm_bytes"),
                            rel_tol=0.05)
        assert traced == real
        assert traced["collectives"] and traced["dot_flops"] > 0
        assert traced["peak_bytes"] > traced["args_bytes"] > 0


def test_ranks_import_no_jax(traced_ranks):
    for r in traced_ranks:
        assert r["modules"] == []


# ---------------------------------------------------------------------------
# dot FLOPs against the JAX HLO count
# ---------------------------------------------------------------------------

FLOP_ARCHS = ("qwen1.5-0.5b", "gemma2-2b", "whisper-base")
FLOP_B, FLOP_S = 2, 1024


def _jax_dot_flops(arch, kind):
    import jax

    from repro import configs as jconfigs
    from repro.common.config import ShapeConfig as JShape
    from repro.common.config import TrainConfig as JTrainConfig
    from repro.common.schema import param_structs
    from repro.launch import hlo_analysis
    from repro.train import step as JS

    cfg = jconfigs.smoke_config(arch)
    shape = JShape("t", FLOP_S, FLOP_B, "train")
    max_seq = FLOP_S if cfg.is_encoder_decoder else 0
    state = param_structs(JS.state_schema(cfg, JTrainConfig(),
                                          max_seq=max_seq))
    batch = JS.batch_structs(cfg, shape)
    if kind == "train":
        fn, args = JS.make_train_step(cfg, JTrainConfig()), (state, batch)
    else:
        batch.pop("labels")
        fn = JS.make_prefill_step(cfg, cache_len=FLOP_S)
        args = (state["params"], batch)
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_analysis.analyze(text).dot_flops


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_dot_flops_match_the_jax_hlo(arch, kind):
    cfg = configs.smoke_config(arch)
    shape = ShapeConfig("t", FLOP_S, FLOP_B, kind)
    case = specs.build_case(cfg, shape, None, TrainConfig(), device="cpu")
    with case.fake_mode:
        got = trace_analysis.analyze(case.fn, *case.args).dot_flops
    want = _jax_dot_flops(arch, kind)
    assert math.isclose(got, want, rel_tol=1e-2), (got, want)


# one recurrent mixer per rank: the split products divided by the model size
MIXER_B, MIXER_S = 1, 1024


def _mixer_dot_flops(kind, mesh):
    """The traced dot FLOPs of one forward of the SSD (mamba2-780m) or
    RG-LRU (recurrentgemma-2b) mixer at its published width, on fake
    tensors: the rank's parameter blocks on ``mesh`` (``None``:
    unsharded) and MIXER_B × MIXER_S rows."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.common.logical import local_shape, to_physical
    from repro_torch.common.schema import leaves
    from repro_torch.models import griffin, ssm
    arch, schema_fn, apply = (
        ("mamba2-780m", ssm.ssd_schema, ssm.ssd_apply) if kind == "ssd"
        else ("recurrentgemma-2b", griffin.rglru_schema,
              griffin.rglru_apply))
    cfg = configs.get_config(arch)
    mode = FakeTensorMode()
    with mode:
        params = {path[-1]: torch.empty(
            d.shape if mesh is None else
            local_shape(d.shape, to_physical(d.logical, mesh), mesh))
            for path, d in leaves(schema_fn(cfg))}
        x = torch.empty(MIXER_B, MIXER_S, cfg.d_model)
        with torch.no_grad():
            got = trace_analysis.analyze(
                lambda p, x: apply(p, x, cfg, mesh=mesh), params, x)
    return cfg, got.dot_flops


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_mixer_dot_flops_split_over_model(kind):
    """Rank 0 of the (16, 16) mesh runs the unsharded layer's products
    with every head- or width-split one divided by 16. SSD (chunk L, nC =
    S / L chunks): whole on every rank, ``b_proj`` and ``c_proj`` (2·B·S·
    D·N each) and the chunks' C·Bᵀ (2·B·L²·N each); split, the z / x / dt
    projections (2·B·S·D·(2·d_inner + H)), ``out_proj`` (2·B·S·d_inner·D)
    and per chunk the intra-chunk product (2·B·H·L²·P), the carried
    state's (2·B·L·H·P·N) and the state update's (2·B·H·N·P·L). RG-LRU:
    all split, w_x and w_gate (2·B·S·D·W each), the two gate products
    (2·B·S·W² each), ``w_out`` (2·B·S·W·D)."""
    from repro_torch.models import ssm
    mesh = meshlib.TraceMesh(("data", "model"), (16, 16), 0,
                             torch.device("cpu"))
    cfg, unsharded = _mixer_dot_flops(kind, None)
    _, rank = _mixer_dot_flops(kind, mesh)
    B, S, D = MIXER_B, MIXER_S, cfg.d_model
    if kind == "ssd":
        E, H, P_, N = ssm.dims(cfg)
        L = cfg.ssm_chunk
        nC = S // L
        whole = 2 * (2 * B * S * D * N) + nC * 2 * B * L * L * N
        split = (2 * B * S * D * (2 * E + H) + 2 * B * S * E * D
                 + nC * 2 * B * H * P_ * L * (L + 2 * N))
    else:
        W = cfg.lru_width
        whole, split = 0, 2 * B * S * (3 * D * W + 2 * W * W)
    assert unsharded == whole + split
    assert rank == whole + split // 16


# ---------------------------------------------------------------------------
# one production trace, the CLI, the launcher, the kernels' refusal
# ---------------------------------------------------------------------------

def test_production_decode_trace_is_complete(tmp_path):
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False,
                          results_dir=str(tmp_path), verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["n_devices"] == 256 and rec["version"] == dryrun.VERSION
    m = rec["memory"]
    assert m["peak_bytes_per_device"] >= m["traced_args_bytes"] > 0
    assert m["args_bytes_per_device_exact"] > m["cache_bytes_per_device"] > 0
    r = rec["roofline"]
    for key in ("flops", "bytes_accessed", "collective_bytes", "t_compute",
                "t_memory", "t_collective", "dominant", "model_flops",
                "bound_s"):
        assert key in r
    assert r["flops"] > 0 and r["collective_bytes"] > 0
    assert rec["fits_hbm"] is True
    assert set(rec["collectives"]) >= {"all_gather", "psum", "result_gather"}
    with open(tmp_path / "qwen1.5-0.5b__decode_32k__pod16x16.json") as f:
        assert json.load(f) == rec
    again = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False,
                            results_dir=str(tmp_path), verbose=False)
    assert again == rec     # a green cell is read back, not traced again
    assert "all_gather" in dryrun.breakdown(rec, "coll")
    assert "mm" in dryrun.breakdown(rec, "hbm")
    peak = f"{m['peak_bytes_per_device'] / 1e9:.2f}"
    assert f"| qwen1.5-0.5b | decode_32k | {peak} · not run |" in \
        dryrun.table(str(tmp_path))


def test_production_long_context_trace_is_complete(tmp_path):
    """long_500k's rule table leaves the B = 1 token whole on every rank,
    and the decode step combines its sequence-sharded cache: one max and
    one sum all-reduce per global layer (gemma2-2b's 13), no row
    gather."""
    rec = dryrun.run_cell("gemma2-2b", "long_500k", False,
                          results_dir=str(tmp_path), verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["n_devices"] == 256 and rec["fits_hbm"] is True
    m = rec["memory"]
    _, jax_caches = _jax_case_bytes("gemma2-2b", "long_500k", False)
    assert m["cache_bytes_per_device"] == jax_caches > 0
    assert m["peak_bytes_per_device"] >= m["traced_args_bytes"] > 0
    coll = rec["collectives"]
    assert coll["decode_max"]["count"] == coll["decode_sum"]["count"] == 13
    assert "result_gather" not in coll
    # gemma2-2b's 8 heads and 4 kv heads do not split over 16 model
    # ranks: the one-token q, k, v are every rank's already
    assert "decode_qkv_gather" not in coll


def test_list_matches_the_jax_dry_run(capsys):
    assert dryrun.main(["--list"]) == 0
    port = capsys.readouterr().out
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    jax_out = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--list"], env=env,
        capture_output=True, text=True, timeout=120, check=True).stdout
    assert port == jax_out
    assert port.splitlines()[-1] == "34 runnable cells (6 documented skips)"


def test_launch_train_dry_run_prints_an_ok_record(tmp_path, monkeypatch,
                                                  capsys):
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    assert launch_train.main(["--workload", "lm", "--arch", "qwen1.5-0.5b",
                              "--shape", "train_4k", "--dry-run"]) == 0
    out = capsys.readouterr().out
    rec = json.loads(out[out.index("{"):])
    assert rec["ok"] and rec["mesh"] == "pod16x16"
    assert rec["shape"] == "train_4k" and rec["fits_hbm"] is True
    assert "grad_all_reduce" in rec["collectives"]


def test_kernels_refuse_fake_tensors_before_any_launch():
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.gas_scatter import kernel as K
    cfg = configs.smoke_config("qwen1.5-0.5b")
    mesh = meshlib.TraceMesh(("data", "model"), (2, 2), 0,
                             torch.device("cpu"))
    FK.reset_launch_counts()
    K.reset_launch_counts()
    for kw, kind, where in (({"impl": "kernel"}, "train",
                             "gas_scatter_fused"),
                            ({"use_flash": True}, "prefill",
                             "flash_attention")):
        case = specs.build_case(cfg, ShapeConfig("x", 16, 4, kind), mesh,
                                TrainConfig(), device="cpu", **kw)
        with case.fake_mode, pytest.raises(NotImplementedError,
                                           match=f"{where} on a fake"):
            trace_analysis.analyze(case.fn, *case.args)
    assert K.launch_counts() == {"gas_scatter_banded": 0,
                                 "gas_scatter_dense": 0}
    assert FK.launch_counts() == {"flash_attention": 0}
    assert FK.flash_attention_plain.calls == 0
    _raw_kernels_refuse_fake_tensors()


def _raw_kernels_refuse_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.gas_scatter import kernel as K
    with FakeTensorMode():
        x = torch.empty(2, 128, 16)
        with pytest.raises(NotImplementedError, match="fake tensor"):
            FK.flash_attention_fwd(x, x, x, causal=True, window=0,
                                   softcap=0.0, kv_len=128, n_kv_heads=2)
        with pytest.raises(NotImplementedError, match="fake tensor"):
            K.gas_scatter_dense(x, x, x, x, 128)
