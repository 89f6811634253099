"""2-stage pipeline-parallel training: the reference ``pp.py`` configuration.

Equivalent to ``python -m ddl_tpu_torch.cli --preset pp``, which the
port refuses for now with the preset's ROADMAP item.
"""

import sys

from ddl_tpu_torch.cli import main

if __name__ == "__main__":
    main(["--preset", "pp", *sys.argv[1:]])
