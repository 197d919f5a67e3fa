from repro_torch.optim.adamw import (adamw_init, adamw_update, sgdm_init,
                                     sgdm_update)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["adamw_init", "adamw_update", "sgdm_init", "sgdm_update",
           "cosine_schedule", "linear_warmup"]
