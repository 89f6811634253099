"""The port's decode bench (ddl_tpu_torch/bench/decode.py) end to end on
the CPU at a tiny size, as ``tests/test_decode.py::test_decode_bench_smoke``
drives the JAX bench: int8 weights and cache (``--quant kv+w``) under a
window smaller than the cache (the rolling ring).  The timings of a CPU run
mean nothing; the row's fields and byte counts are what is checked."""

import json

import pytest

from ddl_tpu_torch.bench import decode as bench_decode

TINY = ["--batch", "1", "--prompt", "16", "--new", "4", "--d-model", "64", "--layers", "2",
        "--vocab", "64", "--kv-heads", "0", "--attn-window", "8", "--iters", "1",
        "--device", "cpu"]


@pytest.mark.parametrize("quant", ["kv+w", "none"])
def test_decode_bench_smoke(capsys, quant):
    bench_decode.main([*TINY, "--quant", quant])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["quant"] == quant and row["device"] == "cpu"
    assert row["decode_tok_per_sec"] > 0 and row["prefill_ms"] > 0
    # the windowed ring allocates O(window); its per-step read spans the
    # same window rows
    assert row["cache_bytes_per_layer"] < row["max_len"] * 2 * 64 * 4
    assert row["read_bytes_per_step_layer"] <= row["cache_bytes_per_layer"]
    # the int8 cache: K and V int8 (1 byte) and one f32 scale per (token, head)
    per_row = 2 * 64 + 2 * 4 if quant == "kv+w" else 2 * 64 * 2
    assert row["cache_bytes_per_layer"] == 8 * per_row


def test_int8_weights_shrink_param_bytes(capsys):
    bench_decode.main([*TINY, "--quant", "kv,kv+w"])
    kv, kvw = (json.loads(line) for line in capsys.readouterr().out.strip().splitlines())
    # every matmul kernel goes from 4 bytes per weight to 1 (+ its scales)
    assert kvw["param_bytes"] < 0.6 * kv["param_bytes"]


def test_bad_quant_mode_is_refused():
    with pytest.raises(SystemExit):
        bench_decode.main([*TINY, "--quant", "w"])
