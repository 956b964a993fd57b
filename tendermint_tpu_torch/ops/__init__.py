"""Device side of the port: batched Ed25519 and sr25519 verification with
PyTorch and hand-written CUDA kernels, under a shared device health
machine; counterpart of :mod:`tendermint_tpu.ops`."""

from tendermint_tpu_torch.ops.ed25519_batch import verify_batch  # noqa: F401
