"""ScaleGANN core of the port (counterpart of ``repro.core``): partition,
CAGRA shard builds and merge, with the distance work on the card."""

from repro_torch.core.builder import (build_scalegann,  # noqa: F401
                                      build_split_only)
from repro_torch.core.merge import (GlobalIndex,  # noqa: F401
                                    merge_shard_indexes)
