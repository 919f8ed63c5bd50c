"""ScaleGANN core of the port (counterpart of ``repro.core``): partition,
CAGRA and Vamana shard builds and merge, with the distance work on the card.

Query serving lives in :mod:`repro_torch.search`; the ``search_index`` /
``split_search`` names re-exported here are deprecation shims.
"""

from repro_torch.core.builder import (build_diskann,  # noqa: F401
                                      build_extended_cagra, build_ggnn,
                                      build_scalegann, build_split_only)
from repro_torch.core.merge import (GlobalIndex,  # noqa: F401
                                    merge_shard_indexes)
from repro_torch.core.search import search_index, split_search  # noqa: F401
