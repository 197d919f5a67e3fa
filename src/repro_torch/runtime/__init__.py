from repro_torch.runtime.elastic import (elastic_data_degree,
                                         elastic_mesh_axes)
from repro_torch.runtime.fault import (ChaosMonkey, WorkerFailure,
                                       backoff_delay, run_with_restarts)
from repro_torch.runtime.monitor import StepMonitor

__all__ = ["ChaosMonkey", "WorkerFailure", "backoff_delay",
           "run_with_restarts", "StepMonitor", "elastic_data_degree",
           "elastic_mesh_axes"]
