"""``python -m tendermint_tpu_torch.e2e <manifest.toml> [--device cuda|cpu]``
(test/e2e/runner)."""

import sys

from tendermint_tpu_torch.e2e.runner import main

if __name__ == "__main__":
    sys.exit(main())
