from repro_torch.data.synthetic import (SyntheticImageDataset,
                                        SyntheticLMDataset,
                                        poisson_batch_indices)

__all__ = ["SyntheticImageDataset", "SyntheticLMDataset",
           "poisson_batch_indices"]
