"""Serve a transformer-LM training snapshot with continuous batching
(counterpart of ``examples/serve_lm.py``).

Point it at the ``--checkpoint-dir``/``--job-id`` of ``train_lm`` and the
same model flags, and the serving engine (``ddl_tpu_torch/serve/``) serves
the saved weights to N concurrent synthetic clients -- paged KV pool,
bucketed prefill, admission control -- and renders the serving report
(p50/p95/p99 latency, queue delay, TTFT, tokens/s; aggregate tokens/s):

    python -m ddl_tpu_torch.examples.train_lm --steps 200 \\
        --checkpoint-dir /tmp/ck --save-every 100
    python -m ddl_tpu_torch.examples.serve_lm --checkpoint-dir /tmp/ck \\
        --job-id lm --step 200 --clients 16 --prompt-len 8:24 --max-new 32:64

It is ``serve-bench`` with a checkpoint required: all flags are shared
(``python -m ddl_tpu_torch.cli serve-bench --help``).
"""

from __future__ import annotations

import sys

__all__ = ["main"]


def main(argv=None) -> None:
    from ddl_tpu_torch.serve.bench import main as bench_main

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--checkpoint-dir" not in argv and "--help" not in argv:
        raise SystemExit(
            "serve_lm serves a training snapshot: --checkpoint-dir (and --step) are "
            "required.  For random-init smoke mode use `python -m ddl_tpu_torch.cli "
            "serve-bench` directly."
        )
    bench_main(argv)


if __name__ == "__main__":
    main()
