from tpuflows_torch.adaptive.loop import (
    AdaptiveConfig,
    AdaptiveResult,
    AdaptiveRound,
    adaptive_fit,
)

__all__ = [
    "AdaptiveConfig",
    "AdaptiveResult",
    "AdaptiveRound",
    "adaptive_fit",
]
