from repro_torch.data.loader import PrefetchLoader, shard_for_host
from repro_torch.data.synthetic import (SyntheticImageDataset,
                                        SyntheticLMDataset,
                                        poisson_batch_indices)

__all__ = ["SyntheticImageDataset", "SyntheticLMDataset",
           "poisson_batch_indices", "PrefetchLoader", "shard_for_host"]
