from tpuflows_torch.util.device import f32_device
from tpuflows_torch.util.profiling import MetricsLogger, Timer, trace
from tpuflows_torch.util.shapes import (VariateShape, flatview, mask_array,
                                        nestedview, num_batches_split)

__all__ = ["f32_device", "MetricsLogger", "Timer", "trace", "VariateShape",
           "flatview", "mask_array", "nestedview", "num_batches_split"]
