"""The distributed layer on `torch.distributed` (port of `tpuflows/dist/`).

`resample_sharded`, `optimize_flow_dp` and `run_nuts_sharded` sit above
the samplers and the trainer, which import this package's collectives, so
they load on first use."""
from tpuflows_torch.dist.failures import (EXIT_PEER_LOSS, CollectiveTimeout,
                                          FailurePolicy, heartbeat,
                                          run_with_timeout)
from tpuflows_torch.dist.mesh import (WORKERS, WorkerMesh, init_distributed,
                                      replicate, row_block, worker_mesh)

_LAZY = {"resample_sharded": "tpuflows_torch.dist.resample",
         "optimize_flow_dp": "tpuflows_torch.dist.train",
         "run_nuts_sharded": "tpuflows_torch.dist.chains"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["WORKERS", "WorkerMesh", "init_distributed", "replicate",
           "row_block", "worker_mesh", "EXIT_PEER_LOSS", "CollectiveTimeout",
           "FailurePolicy", "heartbeat", "run_with_timeout",
           "resample_sharded", "optimize_flow_dp", "run_nuts_sharded"]
