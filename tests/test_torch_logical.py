"""Port parity: the logical axis rules (``repro_torch.common.logical``)
against the JAX package's ``repro.common.logical``.

* ``to_physical`` equals the JAX function on every leaf of every one of
  the ten configs' parameter and optimiser-state schemas, on (4, 2),
  (2, 4) and (2, 2, 2) meshes. The JAX function reads only
  ``mesh.axis_names``, so a stand-in object serves and no fake devices
  are needed;
* the double-use guard, ``resolve_axis``, ``batch_axes`` and ``dp_size``;
* ``local_block``: the blocks of every rank of a mesh tile the full leaf,
  and ``replication`` counts the ranks that hold each element;
* the sharded chunked cross-entropy's chunk rule, ``(B/dp)·(V/tp)·4``
  bytes per device, against the chunk the JAX function scans with.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.common import logical as L
from repro_torch.common.config import TrainConfig
from repro_torch.models.embedding import xent_chunk
from repro_torch.train import step as TS

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

MESHES = {(4, 2): ("data", "model"), (2, 4): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model")}


class StandIn:
    """What the rules read of a mesh: axis names and sizes, and (for
    ``local_block``) one rank's index along a set of axes."""

    def __init__(self, shape, names, rank=0):
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.coords = dict(zip(names, np.unravel_index(rank, shape)))

    def axis_index(self, axes):
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + int(self.coords[a])
        return idx


def _jax_specs(arch):
    from repro import configs as jconfigs
    from repro.common.config import TrainConfig as JTrainConfig
    from repro.common.schema import param_logical_specs
    from repro.train import step as JS
    return param_logical_specs(JS.state_schema(
        jconfigs.get_config(arch), JTrainConfig(grad_compression="int8_ef")))


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_to_physical_equals_the_reference_on_every_leaf(arch, shape):
    from repro.common.logical import to_physical as j_to_physical
    mesh = StandIn(shape, MESHES[shape])
    want = L.spec_leaves(_jax_specs(arch))
    got = L.spec_leaves(TS.state_logical_specs(
        configs.get_config(arch), TrainConfig(grad_compression="int8_ef")))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [s for _, s in got] == [s for _, s in want]
    for path, spec in got:
        phys = L.to_physical(spec, mesh)
        assert isinstance(phys, tuple)
        assert phys == tuple(j_to_physical(spec, mesh)), path


def test_double_use_guard_resolve_and_batch_axes():
    from repro.common import logical as JL
    for shape, names in MESHES.items():
        mesh = StandIn(shape, names)
        for spec in [("embed", "embed"), ("batch", "embed"),
                     ("vocab", "heads"), (("batch", "embed"), None),
                     ("layers", "experts", "embed", None), ("nope",),
                     (None, ("heads", "ff"))]:
            assert L.to_physical(spec, mesh) == tuple(
                JL.to_physical(spec, mesh)), (shape, spec)
        for axis in ("batch", "embed", ("batch", "vocab"), None, "seq"):
            assert L.resolve_axis(axis, names) == JL.resolve_axis(axis,
                                                                  names)
        assert L.batch_axes(mesh) == JL.batch_axes(mesh)
        assert L.dp_size(mesh) == JL.dp_size(mesh)
    assert L.DEFAULT_RULES == JL.DEFAULT_RULES
    mesh = StandIn((2, 2, 2), MESHES[(2, 2, 2)])
    assert L.to_physical(("batch", "embed"), mesh) == (("pod", "data"),
                                                       None)
    assert L.to_physical(("embed", "embed"), mesh) == ("data", None)


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
def test_batch_axes_follow_the_long_context_rule_table(shape):
    """Under the JAX package's long_500k table (``batch=()``) the batch
    resolves to no axis: every rank holds the whole batch, and a row
    spec leaves it whole; the default table's axes are unchanged."""
    from repro.common.logical import to_physical as j_to_physical
    from repro.launch.specs import LONG_CONTEXT_RULES as J_LONG
    from repro_torch.launch.specs import LONG_CONTEXT_RULES
    assert LONG_CONTEXT_RULES == J_LONG
    names = MESHES[shape]
    mesh = StandIn(shape, names)
    assert L.batch_axes(mesh, LONG_CONTEXT_RULES) == ()
    assert L.dp_size(mesh, LONG_CONTEXT_RULES) == 1
    assert L.batch_axes(mesh, L.DEFAULT_RULES) == L.batch_axes(mesh) == \
        tuple(a for a in ("pod", "data") if a in names)
    for spec in [("batch", None), ("batch", "seq_kv", None, None),
                 ("batch", "seq", "embed")]:
        assert L.to_physical(spec, mesh, LONG_CONTEXT_RULES) == tuple(
            j_to_physical(spec, mesh, J_LONG)), spec
    full = np.arange(6).reshape(1, 6)
    for r in range(int(np.prod(shape))):
        blk = L.local_block(full, L.to_physical(("batch", None), mesh,
                                                LONG_CONTEXT_RULES),
                            StandIn(shape, names, r))
        assert (blk == full).all()


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
def test_blocks_of_every_rank_tile_the_leaf(shape):
    names = MESHES[shape]
    full = np.arange(8 * 4 * 8).reshape(8, 4, 8)
    for spec in [("vocab", "embed", None), ("batch", None, "ff"),
                 (None, None, None), ("experts", "embed", "heads")]:
        phys = L.to_physical(spec, StandIn(shape, names))
        seen = np.zeros(full.shape, int)
        n = int(np.prod(shape))
        for r in range(n):
            mesh = StandIn(shape, names, r)
            blk = L.local_block(full, phys, mesh)
            assert blk.shape == L.local_shape(full.shape, phys, mesh)
            np.add.at(seen.reshape(-1), blk.reshape(-1), 1)
        assert (seen == L.replication(phys, StandIn(shape, names))).all()
    with pytest.raises(ValueError, match="split evenly"):
        L.local_block(np.zeros((3, 4)), ("data", None),
                      StandIn(shape, names))


@pytest.mark.parametrize("B,S,V,dp,tp", [
    (4, 256, 151936, 2, 2), (8, 512, 151936, 1, 4), (2, 16, 512, 2, 2),
    (16, 2048, 256000, 4, 8), (1, 7, 64, 1, 1)])
def test_xent_chunk_is_the_reference_per_device_rule(B, S, V, dp, tp):
    """The chunk the JAX ``chunked_softmax_xent`` scans with on a
    (data dp, model tp) mesh, read off its jaxpr's scan length."""
    import jax
    import jax.numpy as jnp
    from repro.models.embedding import chunked_softmax_xent
    mesh = StandIn((dp, tp), ("data", "model"))
    jaxpr = jax.make_jaxpr(lambda x, t, lb: chunked_softmax_xent(
        x, t, lb, mesh=mesh))(jax.ShapeDtypeStruct((B, S, 8), jnp.float32),
                              jax.ShapeDtypeStruct((V, 8), jnp.float32),
                              jax.ShapeDtypeStruct((B, S), jnp.int32))
    scans = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "scan"]
    assert len(scans) == 1
    n = scans[0].params["length"]
    # the port takes the rank's rows and vocab shard
    assert xent_chunk(B // dp, S, V // tp) * n == S
    assert xent_chunk(B, S, V, dp=dp, tp=tp) == S // n


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-moe-16b",
                                  "whisper-base"])
def test_param_structs_and_specs_are_the_reference(arch):
    """``param_structs`` (meta tensors) and ``param_logical_specs`` of a
    full-width schema, leaf for leaf, against the JAX package's
    ``ShapeDtypeStruct`` and spec trees: no parameter is allocated."""
    import jax
    from repro import configs as jconfigs
    from repro.common.schema import param_logical_specs as j_specs
    from repro.common.schema import param_structs as j_structs
    from repro.models import transformer as JT
    from repro_torch.common.schema import (param_logical_specs,
                                           param_structs)
    from repro_torch.common.tree import leaves_with_paths
    from repro_torch.models import transformer as TT
    schema = TT.model_schema(configs.get_config(arch), max_seq=448)
    jschema = JT.model_schema(jconfigs.get_config(arch), max_seq=448)
    got = leaves_with_paths(param_structs(schema))
    want = jax.tree_util.tree_leaves_with_path(j_structs(jschema))
    assert len(got) == len(want)
    for (path, t), (jpath, s) in zip(got, want):
        assert path == tuple(k.key for k in jpath)
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(s.dtype), path
    assert L.spec_leaves(param_logical_specs(schema)) == \
        L.spec_leaves(j_specs(jschema))
