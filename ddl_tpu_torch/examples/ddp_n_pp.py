"""Hybrid data x pipeline parallelism: the reference ``ddp_n_pp.py`` configuration.

Equivalent to ``python -m ddl_tpu_torch.cli --preset dp_pp``: ``mesh.data``
data rows (3 by default) of two stages each, one GPU a rank, started by the
command line.
"""

import sys

from ddl_tpu_torch.cli import main

if __name__ == "__main__":
    main(["--preset", "dp_pp", *sys.argv[1:]])
