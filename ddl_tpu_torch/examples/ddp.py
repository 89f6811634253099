"""Data-parallel training: the reference ``ddp.py`` configuration.

Equivalent to ``python -m ddl_tpu_torch.cli --preset dp``, which the
port refuses for now with the preset's ROADMAP item.
"""

import sys

from ddl_tpu_torch.cli import main

if __name__ == "__main__":
    main(["--preset", "dp", *sys.argv[1:]])
