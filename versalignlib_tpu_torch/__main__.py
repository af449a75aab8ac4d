"""``python -m versalignlib_tpu_torch``: the command line (``cli.py``)."""

import sys

from versalignlib_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
