from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                 CheckpointCorrupt,
                                                 DPTrainState)

__all__ = ["Checkpointer", "CheckpointCorrupt", "DPTrainState"]
