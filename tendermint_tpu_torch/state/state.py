"""sm.State: the deterministic snapshot consensus operates on.

A copy of ``tendermint_tpu/state/state.py``, mirroring internal/state/state.go:68-103 and the Update transition at
internal/state/execution.go:527-596 (validator-set rotation with the
next-valset delay, consensus-param updates effective next height,
LastResultsHash/AppHash threading).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field, replace
from typing import List, Optional

from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.types.block import BlockID, Consensus, GO_ZERO_TIME, Header
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.params import ConsensusParams, ConsensusParamsUpdate
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet


@dataclass
class State:
    version: Consensus = dc_field(default_factory=Consensus)
    chain_id: str = ""
    initial_height: int = 1

    last_block_height: int = 0  # 0 at genesis
    last_block_id: BlockID = dc_field(default_factory=BlockID)
    last_block_time: Timestamp = GO_ZERO_TIME

    next_validators: Optional[ValidatorSet] = None
    validators: Optional[ValidatorSet] = None
    last_validators: Optional[ValidatorSet] = None
    last_height_validators_changed: int = 0

    consensus_params: ConsensusParams = dc_field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0

    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def copy(self) -> "State":
        return replace(
            self,
            next_validators=self.next_validators.copy()
            if self.next_validators
            else None,
            validators=self.validators.copy() if self.validators else None,
            last_validators=self.last_validators.copy()
            if self.last_validators
            else None,
        )

    def is_empty(self) -> bool:
        return self.validators is None

    def update(
        self,
        block_id: BlockID,
        header: Header,
        results_hash: bytes,
        consensus_param_updates: Optional[ConsensusParamsUpdate],
        validator_updates: List[Validator],
    ) -> "State":
        """internal/state/execution.go:527-596."""
        n_val_set = self.next_validators.copy()
        last_height_vals_changed = self.last_height_validators_changed
        if validator_updates:
            n_val_set.update_with_change_set(validator_updates)
            # Changes at this height apply at height+2 (next-valset delay).
            last_height_vals_changed = header.height + 1 + 1
        n_val_set.increment_proposer_priority(1)

        next_params = self.consensus_params
        last_height_params_changed = self.last_height_consensus_params_changed
        version = self.version
        if consensus_param_updates is not None:
            next_params = self.consensus_params.update_from(consensus_param_updates)
            next_params.validate()
            version = Consensus(version.block, next_params.version.app_version)
            last_height_params_changed = header.height + 1

        # AppHash is filled after ABCI Commit (save path).
        return State(
            version=version,
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=header.height,
            last_block_id=block_id,
            last_block_time=header.time,
            next_validators=n_val_set,
            validators=self.next_validators.copy(),
            last_validators=self.validators.copy(),
            last_height_validators_changed=last_height_vals_changed,
            consensus_params=next_params,
            last_height_consensus_params_changed=last_height_params_changed,
            last_results_hash=results_hash,
            app_hash=b"",
        )


def state_from_genesis(genesis: GenesisDoc) -> State:
    """internal/state/state.go MakeGenesisState."""
    genesis.validate_and_complete()
    if genesis.validators:
        validator_set = genesis.validator_set()
        next_validator_set = genesis.validator_set()
        next_validator_set.increment_proposer_priority(1)
    else:
        # Validators come from ABCI InitChain.
        validator_set = ValidatorSet()
        next_validator_set = ValidatorSet()
    return State(
        version=Consensus(app=genesis.consensus_params.version.app_version),
        chain_id=genesis.chain_id,
        initial_height=genesis.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time=genesis.genesis_time,
        next_validators=next_validator_set,
        validators=validator_set,
        last_validators=ValidatorSet(),
        last_height_validators_changed=genesis.initial_height,
        consensus_params=genesis.consensus_params,
        last_height_consensus_params_changed=genesis.initial_height,
        last_results_hash=b"",
        app_hash=genesis.app_hash,
    )
