"""``python -m tendermint_tpu_torch``: the operator command line
(``cli.py``).

The process ends with ``os._exit`` once the command has returned, its
``atexit`` handlers have run (a trace file's flush among them) and its
output is flushed: a daemon thread still inside a torch call when the
interpreter finalizes aborts the process (a stopped node's vote
pre-verifier warm-up probe on the CPU, say, which takes seconds of
plain-kernel work), and the exit code must be the command's.
"""

import atexit
import os
import sys

from tendermint_tpu_torch.cli import main

if __name__ == "__main__":
    try:
        rc = main()
    except SystemExit as exc:  # argparse's usage errors, --help
        rc = exc.code if isinstance(exc.code, int) else (0 if exc.code is None else 1)
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
