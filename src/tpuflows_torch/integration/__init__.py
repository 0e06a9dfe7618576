"""Evidence (marginal likelihood) estimation (port of
`tpuflows/integration`)."""
from tpuflows_torch.integration.evidence import (
    EvidenceResult,
    log_evidence_bridge,
    log_evidence_harmonic,
    log_evidence_is,
)

__all__ = [
    "EvidenceResult",
    "log_evidence_bridge",
    "log_evidence_harmonic",
    "log_evidence_is",
]
