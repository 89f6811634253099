"""The port's command-line entry points, run as ``python -m
ddl_tpu_torch.examples.<name>``: the LM's (counterparts of
``examples/train_lm.py`` and ``examples/generate_lm.py``) and the
reference scripts' shims over ``ddl_tpu_torch.cli`` (``single``, ``ddp``,
``pp``, ``ddp_n_pp``)."""
