"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's: every case of ``tests/test_sharding.py`` on the port, and
every parameter of every arch resolved to the reference's spec on both
production meshes, with the default and the sequence-parallel rules."""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JaxSpec

from repro.common import params as jpar
from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import get_arch as jget_arch
from repro.distributed import sharding as jshd
from repro.models.model import build_model as jbuild_model
from repro_torch.common import params as par
from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Mesh, PartitionSpec
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import build_model


class FakeMesh:
    """The reference's spec-resolution stand-in (tests/test_sharding.py)."""

    def __init__(self, shape=(2, 16, 16), axes=("pod", "data", "model")):
        self.axis_names = axes
        self.devices = np.zeros(shape)


def _mesh(shape=(2, 16, 16), axes=("pod", "data", "model")):
    return Mesh(axes, shape)


def test_resolve_divisible():
    spec = shd.resolve_spec(("embed", "mlp"), (2048, 8192), _mesh())
    assert spec == PartitionSpec(("pod", "data"), "model")


def test_resolve_drops_nondivisible_axis():
    m = _mesh()
    assert shd.resolve_spec(("heads",), (40,), m) == PartitionSpec()
    assert shd.resolve_spec(("embed",), (2048,), m) == \
        PartitionSpec(("pod", "data"))
    assert shd.resolve_spec(("embed",), (6,), m) == PartitionSpec("pod")


def test_resolve_no_axis_reuse():
    spec = shd.resolve_spec(("mlp", "experts"), (8192, 128), _mesh())
    assert spec == PartitionSpec("model")


def test_batch_sharding_small_batch():
    assert shd.resolve_spec(("batch",), (1,), _mesh()) == PartitionSpec()


def test_constrain_noop_without_context():
    x = torch.ones(4, 4)
    assert shd.constrain(x, "batch", None) is x


def test_constrain_under_context_is_identity_and_checks_rank():
    x = torch.ones(4, 4)
    with shd.use_mesh_rules(make_production_mesh()):
        assert shd.constrain(x, "batch", None) is x
        with pytest.raises(ValueError, match="do not match"):
            shd.constrain(x, "batch", None, None)
    assert shd.constrain(x, "batch", None, None) is x  # context left


def test_seq_parallel_rules():
    r = shd.seq_parallel_rules()
    spec = shd.resolve_spec(("batch", "seq", "act_embed"), (1, 524288, 4096),
                            _mesh(), r)
    assert spec == PartitionSpec(None, "model")


def test_partition_spec_spelling_and_trim():
    assert PartitionSpec("data", None, None) == PartitionSpec("data")
    for parts in [(("pod", "data"), "model"), (), (None, "model"),
                  ("data",)]:
        assert str(PartitionSpec(*parts)) == str(JaxSpec(*parts))


def test_fsdp_shards_bulk_of_params():
    """≥80% of phi3-medium parameter bytes are sharded on the single-pod
    mesh, as in the reference's test."""
    m = _mesh((16, 16), ("data", "model"))
    model = build_model(get_arch("phi3_medium_14b"))
    sharded, total = 0, 0
    for _, p in par.flatten_with_paths(model.spec):
        n = math.prod(p.shape)
        factor = shd.NamedSharding(
            m, shd.resolve_spec(p.axes, p.shape, m)).shard_factor()
        total += n
        sharded += n if factor > 1 else 0
    assert sharded / total > 0.8


def test_production_and_host_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512 and single.devices is multi.devices is None
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),)


def test_arch_ids_match():
    assert ARCH_IDS == J_ARCH_IDS


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JaxSpec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    """Every parameter of every arch: the port's spec equals the
    reference's, as tuples, on both production meshes, with the default
    and the sequence-parallel rules; ``shard_info`` dicts are equal; the
    flattened paths equal the reference's."""
    model = build_model(get_arch(arch), max_seq_len=448)
    jmodel = jbuild_model(jget_arch(arch), max_seq_len=448)
    flat = par.flatten_with_paths(model.spec)
    jflat = jpar.flatten_with_paths(jmodel.spec)
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        for rules in (None, shd.seq_parallel_rules()):
            jrules = None if rules is None else jshd.seq_parallel_rules()
            m, fm = _mesh(shape, axes), FakeMesh(shape, axes)
            for (path, p), (_, jp) in zip(flat, jflat):
                assert (p.shape, p.axes) == (jp.shape, jp.axes), path
                got = shd.resolve_spec(p.axes, p.shape, m, rules)
                want = jshd.resolve_spec(jp.axes, jp.shape, fm, jrules)
                assert tuple(got) == tuple(want), (path, got, want)
            sh = shd.param_shardings(model.spec, m, rules)
            jspecs = jpar.tree_map_p(
                lambda p: jshd.resolve_spec(p.axes, p.shape, fm, jrules),
                jmodel.spec)
            counts: dict = {}
            for s in _jax_leaves(jspecs):
                counts[str(s)] = counts.get(str(s), 0) + 1
            assert shd.shard_info(sh) == counts
            assert any("model" in k for k in counts), f"{arch}: no TP"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_logical_axes_equal_reference(arch):
    """``Model.abstract_params`` (meta tensors, nothing allocated) and
    ``Model.logical_axes`` leaf for leaf against the reference's
    ``ShapeDtypeStruct`` and axes trees, in the reference's order."""
    import jax.numpy as jnp

    model = build_model(get_arch(arch), max_seq_len=448)
    jmodel = jbuild_model(jget_arch(arch), max_seq_len=448)
    got = par.flatten_with_paths(model.abstract_params(torch.bfloat16))
    want = jpar.flatten_with_paths(jmodel.abstract_params(jnp.bfloat16))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, sds) in zip(got, want):
        assert t.is_meta and tuple(t.shape) == tuple(sds.shape), path
        assert str(t.dtype)[6:] == str(sds.dtype), path
    axes, jaxes = model.logical_axes(), jmodel.logical_axes()
    for path, _ in got:  # each leaf's axes tuple, found by its path
        node, jnode = axes, jaxes
        for key in path.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
            jnode = (jnode[int(key)] if isinstance(jnode, (list, tuple))
                     else jnode[key])
        assert node == tuple(jnode), path
