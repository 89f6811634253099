"""Communication microbenchmark: the reference ``communication_time.py``.

Equivalent to ``python -m ddl_tpu_torch.bench.comm``: two ranks by
default (``--ranks N``), one GPU each, the 4 MiB ping-pong rows into
``training_logs/communication_time.csv`` and the collectives' bandwidth.
"""

from ddl_tpu_torch.bench.comm import main

if __name__ == "__main__":
    main()
