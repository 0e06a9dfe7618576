from tpuflows_torch.util.device import f32_device
from tpuflows_torch.util.shapes import mask_array

__all__ = ["f32_device", "mask_array"]
