"""Device side of the port: batched Ed25519 and sr25519 verification with
PyTorch and hand-written CUDA kernels, under a shared device health
machine; counterpart of :mod:`tendermint_tpu.ops`."""

from tendermint_tpu_torch.ops.ed25519_batch import verify_batch  # noqa: F401


def bind_metrics(metrics) -> None:
    """Mirror every ported unit of the verify path into one
    ``libs.metrics.OpsMetrics`` (None unbinds them): the health machine,
    both caches, the resident store, the challenge hash and the
    device-byte ledger with the kernel profiler. The binding block of
    the reference's node assembly, cut to the ported units; each unit is
    process-wide, so the last binder wins."""
    from tendermint_tpu_torch.ops import device_policy, hash512, introspect, precompute, resident

    device_policy.shared.bind_metrics(metrics)
    precompute.bind_metrics(metrics)
    resident.bind_metrics(metrics)
    hash512.bind_metrics(metrics)
    introspect.bind_metrics(metrics)
