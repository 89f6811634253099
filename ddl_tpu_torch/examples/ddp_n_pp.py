"""Hybrid data x pipeline parallelism: the reference ``ddp_n_pp.py`` configuration.

Equivalent to ``python -m ddl_tpu_torch.cli --preset dp_pp``, which the
port refuses for now with the preset's ROADMAP item.
"""

import sys

from ddl_tpu_torch.cli import main

if __name__ == "__main__":
    main(["--preset", "dp_pp", *sys.argv[1:]])
