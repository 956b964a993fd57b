"""Validator signing: the file-backed signer with its double-sign guard;
counterpart of :mod:`tendermint_tpu.privval` without the remote signers
(ROADMAP §A item 8f)."""

from tendermint_tpu_torch.privval.base import PrivValidator
from tendermint_tpu_torch.privval.file_pv import DoubleSignError, FilePV

__all__ = ["DoubleSignError", "FilePV", "PrivValidator"]
