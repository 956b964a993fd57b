"""Block, commit, validator-set, genesis and params types and commit
verification; counterpart of :mod:`tendermint_tpu.types`, reduced to
what ``verify_commit``, block sync, the block executor and the light
client read."""
