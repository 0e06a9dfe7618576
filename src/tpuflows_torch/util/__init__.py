"""Device, profiling and shape helpers (port of `tpuflows/util/`).

Left out of the port: `pytree_dataclass` and `static_field`, which
register a class as a JAX pytree (its leaves traced by `jit`, its static
fields hashed into the compiled program); eager PyTorch traces nothing,
and plain classes (`torch.nn.Module`, NamedTuple) stand for them."""
from tpuflows_torch.util.device import f32_device
from tpuflows_torch.util.profiling import MetricsLogger, Timer, trace
from tpuflows_torch.util.shapes import (VariateShape, flatview, mask_array,
                                        nestedview, num_batches_split)

__all__ = ["f32_device", "MetricsLogger", "Timer", "trace", "VariateShape",
           "flatview", "mask_array", "nestedview", "num_batches_split"]
