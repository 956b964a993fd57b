"""PyTorch/CUDA port of the tendermint_tpu batch-verification path.

The package mirrors the module names of :mod:`tendermint_tpu` so each
file has an obvious counterpart there, but it imports nothing from it
(nor ``jax``): what it needs of the reference's jax-free modules is
copied. The device work runs in five hand-written CUDA kernels
(``csrc/ed25519_verify.cu``, ``csrc/sha512_challenge.cu``) behind
``ops/cuda_verify.py`` and ``ops/cuda_hash.py``; every kernel has a plain
PyTorch version that runs for CPU tensors. Both signature engines
(ed25519, sr25519) share one device health machine
(``ops/device_policy.py``).

Entry points (``ops.verify_batch``, ``ops.sr25519_batch.verify_batch_sr``,
``crypto.batch.Ed25519BatchVerifier`` and ``MultiBatchVerifier``,
``crypto.sr25519.Sr25519BatchVerifier``,
``types.validation.verify_commit`` and its light variants,
``parallel.pipeline.verify_commits_pipelined``, the ``light.verifier``
entry points, ``light.batch.evaluate_candidates`` and
``light.client.LightClient``, which ``light.lightd.LightServer`` serves)
take ``device=``.
Without it they use :data:`DEFAULT_DEVICE`, which is ``"cuda"``: where
CUDA is absent they raise rather than run on the CPU. Tests set
``DEFAULT_DEVICE = "cpu"``. The shared scheduler
(``crypto.batch.get_shared_scheduler``) and the vote ingest that rides it
(``consensus.reactor.VotePreverifier`` into ``types.vote_set.VoteSet``)
resolve :data:`DEFAULT_DEVICE` at each flush, the same way; so
``evaluate_candidates`` on the shared scheduler, and so a
``LightClient`` that bisects in rounds, refuses a ``device=`` other than
:data:`DEFAULT_DEVICE`.
"""

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None):
    """``device`` (or :data:`DEFAULT_DEVICE`) as a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable:
    the port never moves device work to the CPU on its own.
    """
    import torch

    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tendermint_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"tendermint_tpu_torch: unsupported device {dev}")
    return dev
