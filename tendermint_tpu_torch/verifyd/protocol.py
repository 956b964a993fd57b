"""The priority classes of the verify service's protocol.

The part of ``tendermint_tpu/verifyd/protocol.py`` (``:98-106``) that
the scheduler's callers pass as ``priority``: a lower value is flushed
first when more lanes are pending than one batch holds.
"""

CLASS_CONSENSUS = 0
CLASS_BLOCKSYNC = 1
CLASS_LIGHT = 2
CLASS_RPC = 3
CLASS_NAMES = {
    CLASS_CONSENSUS: "consensus",
    CLASS_BLOCKSYNC: "blocksync",
    CLASS_LIGHT: "light",
    CLASS_RPC: "rpc",
}
