from tpuflows_torch.io.checkpoint import (latest_checkpoint, load_pytree,
                                          save_pytree)

__all__ = ["latest_checkpoint", "load_pytree", "save_pytree"]
