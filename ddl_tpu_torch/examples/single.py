"""Single-device training: the reference ``single.py`` configuration.

Equivalent to ``python -m ddl_tpu_torch.cli --preset single``; further
arguments (``--set ...``, ``--device cpu``) pass through.
"""

import sys

from ddl_tpu_torch.cli import main

if __name__ == "__main__":
    main(["--preset", "single", *sys.argv[1:]])
