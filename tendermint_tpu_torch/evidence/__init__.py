"""Evidence pool, verification and gossip reactor (internal/evidence/)."""

from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.evidence.verify import InvalidEvidenceError, verify_duplicate_vote, verify_light_client_attack

__all__ = ["EvidencePool", "InvalidEvidenceError", "verify_duplicate_vote", "verify_light_client_attack"]
