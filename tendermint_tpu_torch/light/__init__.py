"""Light client (reference: light/): stateless verification, the
bisection client with its trusted store and fork detector, and its
serving tier (``light/lightd.py``); counterpart of
:mod:`tendermint_tpu.light`."""

from tendermint_tpu_torch.light.verifier import (
    DEFAULT_TRUST_LEVEL,
    HeaderExpiredError,
    InvalidHeaderError,
    NewValSetCantBeTrustedError,
    header_expired,
    validate_trust_level,
    verify,
    verify_adjacent,
    verify_backwards,
    verify_non_adjacent,
)
from tendermint_tpu_torch.light.client import LightClient, TrustOptions
from tendermint_tpu_torch.light.provider import Provider, MemoryProvider
from tendermint_tpu_torch.light.store import LightStore

__all__ = [
    "DEFAULT_TRUST_LEVEL",
    "HeaderExpiredError",
    "InvalidHeaderError",
    "LightClient",
    "LightStore",
    "MemoryProvider",
    "NewValSetCantBeTrustedError",
    "Provider",
    "TrustOptions",
    "header_expired",
    "validate_trust_level",
    "verify",
    "verify_adjacent",
    "verify_backwards",
    "verify_non_adjacent",
]
