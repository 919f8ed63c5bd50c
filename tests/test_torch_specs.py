"""The dry-run's cells and input specs (``repro_torch.configs.base`` and
``repro_torch.launch.specs``) against the reference's: the 40 cells with
their skip reasons, every runnable cell's batch specs, and every decode
cell's cache leaves in shape, dtype and sharding on both production
meshes (the port's per-layer cache against the reference's stacked one,
its block axis dropped).  Nothing allocates: every leaf is on ``meta``."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import specs as jspecs
from repro_torch.configs import base
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh

RUNNABLE = [(a, s) for a, s, ok, _ in base.cells() if ok]
DECODE = [(a, s) for a, s in RUNNABLE if base.SHAPES[s].kind == "decode"]
_DT = {np.dtype("int32"): torch.int32, np.dtype(jax.numpy.bfloat16):
       torch.bfloat16, np.dtype("float32"): torch.float32}


class FakeMesh:
    """The reference's spec-resolution stand-in (tests/test_sharding.py)."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.zeros(shape)


def test_cells_equal_reference():
    assert base.cells() == jbase.cells()
    assert len(base.cells()) == 40 and len(RUNNABLE) == 32
    skipped = [(a, s) for a, s, ok, _ in base.cells() if not ok]
    assert len(skipped) == 8 and {s for _, s in skipped} == {"long_500k"}
    for name, shape in base.SHAPES.items():
        j = jbase.SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind,
                shape.resolved_microbatch) == (
            j.seq_len, j.global_batch, j.kind, j.resolved_microbatch)
    assert base.SUBQUADRATIC_FAMILIES == jbase.SUBQUADRATIC_FAMILIES
    for m, jm in ((base.SINGLE_POD, jbase.SINGLE_POD),
                  (base.MULTI_POD, jbase.MULTI_POD)):
        assert (m.shape, m.axes, m.n_devices) == (jm.shape, jm.axes,
                                                   jm.n_devices)


def _same(t: torch.Tensor, sds) -> bool:
    return (tuple(t.shape) == tuple(sds.shape)
            and t.dtype == _DT[np.dtype(sds.dtype)])


@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_batch_specs_equal_reference(arch, shape):
    cfg, jcfg = base.get_arch(arch), jbase.get_arch(arch)
    sh, jsh = base.SHAPES[shape], jbase.SHAPES[shape]
    if sh.kind == "decode":
        cell = specs.make_cell(cfg, sh)
        tok, pos = cell.token_specs
        assert tuple(tok.shape) == (sh.global_batch,) and pos.dim() == 0
        assert tok.is_meta and pos.is_meta
        return
    for labels in (True, False):
        got = specs.batch_specs(cfg, sh, with_labels=labels)
        want = jspecs.batch_specs(jcfg, jsh, with_labels=labels)
        assert list(got) == list(want)
        for k in got:
            assert got[k].is_meta and _same(got[k], want[k]), k


def _cache_pairs(cache, jcache, cfg):
    """(port leaf, reference leaf, its name) with the reference's block
    axis dropped: port layer i is the reference's position i % period."""
    period = len(jcache["layers"])
    for i, lc in enumerate(cache["layers"]):
        for name, leaf in lc.items():
            yield leaf, jcache["layers"][i % period][name], name, i
    for i, kv in enumerate(cache.get("cross_kv", [])):
        for name, leaf in kv.items():
            yield leaf, jcache["cross_kv"][name], name, i


@pytest.mark.parametrize("arch,shape", DECODE)
def test_cache_specs_equal_reference(arch, shape, monkeypatch):
    cfg, jcfg = base.get_arch(arch), jbase.get_arch(arch)
    cell = specs.make_cell(cfg, base.SHAPES[shape])
    jcell = jspecs.make_cell(jcfg, jbase.SHAPES[shape])
    pairs = list(_cache_pairs(cell.cache_specs, jcell.cache_specs, cfg))
    n_ref = sum(int(leaf.shape[0]) for leaf in
                jax.tree.leaves(jcell.cache_specs))
    assert len(pairs) == n_ref  # one port leaf per reference block entry
    for leaf, jleaf, name, _ in pairs:
        assert leaf.is_meta
        assert tuple(leaf.shape) == tuple(jleaf.shape[1:]), name
        assert leaf.dtype == _DT[np.dtype(jleaf.dtype)], name
    # the reference's own cache_shardings, its NamedSharding reduced to
    # the spec (its meshes would need 512 devices)
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        fm = FakeMesh(tuple(mesh.axis_sizes), tuple(mesh.axis_names))
        got = specs.cache_shardings(cell.cache_specs, mesh)
        want = jspecs.cache_shardings(jcell.cache_specs, fm)
        for sh, jspec, name, i in _cache_pairs(got, want, cfg):
            assert tuple(sh.spec) == tuple(jspec)[1:] or (
                tuple(jspec) == () and tuple(sh.spec) == ()), (name, i)
