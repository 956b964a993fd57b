"""End-to-end test harness: manifest-driven multi-process testnets.

A copy of ``tendermint_tpu/e2e/``, whose node, app and signer processes
are the port's. The test/e2e analog: TOML manifests describe a topology,
the runner stages setup -> start -> load -> perturb -> wait -> test ->
stop, and invariant checks run against the live network over RPC only
(test/e2e/README.md:60-80, runner/).
"""

from tendermint_tpu_torch.e2e.manifest import Manifest, NodeManifest
from tendermint_tpu_torch.e2e.runner import Runner

__all__ = ["Manifest", "NodeManifest", "Runner"]
