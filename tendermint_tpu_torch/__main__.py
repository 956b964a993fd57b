"""``python -m tendermint_tpu_torch``: the operator command line
(``cli.py``)."""

import sys

from tendermint_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
