"""``repro_torch`` stands alone: it imports neither ``jax`` nor the ``repro``
package (the subprocess below imports every module of the port's search,
build, data, serving and telemetry paths, builds a DiskANN index and
searches it on the ``torch`` and ``numpy`` backends, serves one request
through ``AnnServer``, and runs a fleet build with a kill through
``repro_torch.fleet`` and its scheduler and cost model), and its entry
points run on the card unless the CPU
is asked for — without CUDA they raise instead of carrying on quietly on
the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

SCRIPT = r"""
import sys
import numpy as np
from repro_torch.configs.base import IndexConfig
from repro_torch.core.builder import build_scalegann
from repro_torch.data.synthetic import make_clustered, recall_at
from repro_torch.search import search

ds = make_clustered(600, 16, n_queries=8, spread=1.0, seed=11, device="cpu")
cfg = IndexConfig(n_clusters=2, degree=8, build_degree=16, block_size=256)
res = build_scalegann(ds.data, cfg, device="cpu")
ids, stats = search(res.topology(ds.data), ds.queries, 5, width=16,
                    dtype="uint8", device="cpu")
ids2, _ = search(res.shard_topology(ds.data), ds.queries, 5, width=16,
                 nprobe="auto", device="cpu")
assert ids.shape == ids2.shape == (8, 5) and stats.n_queries == 8
assert recall_at(ids, ds.gt, 5) > 0.5

import repro_torch.core.search, repro_torch.data.pipeline
from repro_torch.core import build_diskann
from repro_torch.data.formats import read_bin, write_bin
from repro_torch.search import beam_search

dk = build_diskann(ds.data, cfg, device="cpu")
for backend in ("torch", "numpy"):
    ids3, _ = dk.search(ds.data, ds.queries, 5, backend=backend, width=16,
                        device="cpu")
    assert ids3.shape == (8, 5) and recall_at(ids3, ds.gt, 5) > 0.5

import torch
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models.model import build_model
from repro_torch.serve import Request, ServeConfig, ServeEngine

lm = build_model(smoke_config(get_arch("tinyllama_1_1b")))
params = lm.init(seed=0, device="cpu")
logits, cache = lm.prefill_fn(params, {"tokens": torch.ones(2, 9, dtype=torch.long)}, 16)
logits, cache = lm.decode_fn(params, cache, logits[:, :256].argmax(-1), 9)
assert logits.shape == (2, 256) and bool(torch.isfinite(logits.float()).all())
reqs = [Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=3)]
ServeEngine(lm, params, ServeConfig(max_len=16), device="cpu").generate(reqs)
assert reqs[0].done and len(reqs[0].output) == 3
import asyncio
import repro_torch.serving.policy, repro_torch.serving.queue
import repro_torch.serving.server, repro_torch.serving.stats
import repro_torch.telemetry.jit, repro_torch.telemetry.metrics
import repro_torch.telemetry.trace, repro_torch.telemetry.validate
from repro_torch.serving import AnnServer, ServingConfig


async def serve_one():
    async with AnnServer(res.topology(ds.data), ServingConfig(k=5, width=16),
                         device="cpu") as srv:
        return await srv.submit(ds.queries[0])

out = asyncio.run(serve_one())
direct, _ = search(res.topology(ds.data), ds.queries[:1], 5, width=16,
                  device="cpu")
assert (out.ids == direct[0]).all()
import tempfile
import repro_torch.durability, repro_torch.live
from repro_torch.live import LiveConfig, LiveIndex

li = LiveIndex.from_build(res, ds.data, cfg, LiveConfig(), device="cpu")
li.prepare("uint8")
with tempfile.TemporaryDirectory() as root:
    li.save(root)
    gids = li.insert_batch(ds.queries[:4] + 0.01)
    li.delete_batch(gids[:1])
    li.close()
    back = LiveIndex.load(root, cfg, LiveConfig(), device="cpu")
    assert back.wal_seq == 2 and back.n_vectors == len(ds.data) + 4
    found, _ = search(back.snapshot(), ds.queries[1:4] + 0.01, 1, width=16,
                      device="cpu")
    assert (found[:, 0] == gids[1:]).all()
    back.close()
import repro_torch.core.cost_model, repro_torch.core.scheduler
import repro_torch.fleet.checkpoint, repro_torch.fleet.executor
import repro_torch.fleet.injector
from repro_torch.core.scheduler import RuntimeModel
from repro_torch.fleet import PreemptionInjector, build_scalegann_fleet

fl = build_scalegann_fleet(ds.data, cfg, n_workers=2, device="cpu",
                           injector=PreemptionInjector(kill_shard_at={0: 1}),
                           runtime_model=RuntimeModel(1e-4))
assert fl.report.n_preemptions == 1 and fl.report.cost.total > 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("FOREIGN", bad)
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout, out.stdout


def test_package_sources_never_name_jax_or_reference():
    paths = sorted((SRC / "repro_torch").rglob("*.py"))
    names = {p.relative_to(SRC / "repro_torch").as_posix() for p in paths}
    assert {"fleet/__init__.py", "fleet/checkpoint.py", "fleet/executor.py",
            "fleet/injector.py", "core/scheduler.py",
            "core/cost_model.py"} <= names
    for path in paths:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                mod = stripped.split()[1]
                assert mod.split(".")[0] not in ("jax", "repro", "jaxlib"), \
                    (path, line)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.configs.base import IndexConfig
    from repro_torch.core.builder import build_diskann, build_scalegann
    from repro_torch.core.vamana import build_shard_index_vamana
    from repro_torch.data.synthetic import make_clustered
    from repro_torch.search import (ShardTopology, search,
                                    topology_from_arrays)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    graph = np.zeros((64, 4), np.int32)
    topo = topology_from_arrays(data, graph=graph, medoid=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        search(topo, data[:2], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_scalegann(data, IndexConfig(n_clusters=2, degree=4,
                                          build_degree=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_clustered(64, 8, n_queries=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        search(topo, data[:2], 2, backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_diskann(data, IndexConfig(n_clusters=2, degree=4,
                                        build_degree=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_shard_index_vamana(data, IndexConfig(degree=4, build_degree=8))
    from repro_torch.live import LiveIndex
    topo = ShardTopology(data=data, shard_ids=[np.arange(64)],
                         shard_graphs=[graph], centroids=data[:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveIndex.from_topology(topo, IndexConfig(degree=4, build_degree=8))
    from repro_torch.core.scheduler import RuntimeModel, calibrate_runtime
    from repro_torch.fleet import build_scalegann_fleet
    with pytest.raises(RuntimeError, match="CUDA"):
        build_scalegann_fleet(data, IndexConfig(n_clusters=2, degree=4,
                                                build_degree=8),
                              runtime_model=RuntimeModel(1e-4))
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate_runtime(None, data, (16, 32), backend="torch")
    assert resolve_device("cpu").type == "cpu"


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    lm = build_model(smoke_config(get_arch("tinyllama_1_1b")))
    params = lm.init(seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(lm, params, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache_fn(1, 8)
