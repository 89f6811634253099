"""2-stage pipeline-parallel training: the reference ``pp.py`` configuration.

Equivalent to ``python -m ddl_tpu_torch.cli --preset pp``: two ranks,
stages 0 and 1 split at denseblock3, one GPU each, started by the command
line.
"""

import sys

from ddl_tpu_torch.cli import main

if __name__ == "__main__":
    main(["--preset", "pp", *sys.argv[1:]])
