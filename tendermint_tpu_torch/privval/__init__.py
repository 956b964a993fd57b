"""Validator signing: the file-backed signer with its double-sign guard;
counterpart of :mod:`tendermint_tpu.privval`. The remote signers are
``privval/remote.py`` (socket) and ``privval/grpc.py``."""

from tendermint_tpu_torch.privval.base import PrivValidator
from tendermint_tpu_torch.privval.file_pv import DoubleSignError, FilePV

__all__ = ["DoubleSignError", "FilePV", "PrivValidator"]
