"""The LM's command-line entry points (counterparts of ``examples/train_lm.py``
and ``examples/generate_lm.py``), run as ``python -m
ddl_tpu_torch.examples.<name>``."""
