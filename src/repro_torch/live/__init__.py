"""Online mutation layer (counterpart of ``repro.live``): batched inserts,
tombstone deletes, background consolidation, and kmeans shard splits over
the shard search engine — served through immutable copy-on-write snapshot
generations, made crash-consistent by :mod:`repro_torch.durability`
(mutation WAL + atomic checksummed snapshots via ``LiveIndex.save`` /
``LiveIndex.load``).  See :mod:`repro_torch.live.index` for the design
notes.
"""

from repro_torch.live.index import LiveConfig, LiveIndex

__all__ = ["LiveConfig", "LiveIndex"]
