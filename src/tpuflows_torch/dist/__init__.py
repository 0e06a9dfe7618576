from tpuflows_torch.dist.failures import (EXIT_PEER_LOSS, CollectiveTimeout,
                                          FailurePolicy, run_with_timeout)

__all__ = ["EXIT_PEER_LOSS", "CollectiveTimeout", "FailurePolicy",
           "run_with_timeout"]
