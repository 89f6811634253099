"""Data-parallel training: the reference ``ddp.py`` configuration.

Equivalent to ``python -m ddl_tpu_torch.cli --preset dp``: ``mesh.data``
ranks (2 by default), one GPU each, started by the command line.
"""

import sys

from ddl_tpu_torch.cli import main

if __name__ == "__main__":
    main(["--preset", "dp", *sys.argv[1:]])
