"""The serving statistics and the bench (ddl_tpu_torch/obs/serving.py,
ddl_tpu_torch/serve/bench.py, ddl_tpu_torch/examples/serve_lm.py) against
the JAX package's: ``ServingStats``, ``TDigest``, ``QuantileAccumulator``
and ``render_percentiles`` equal to JAX's on fixed event lists (the
compressed digest regime and state round trips included); ``_make_clients``
gives JAX's clients for the same ``--seed`` in every scenario (the
traffic a benchmark cell will be defined by); the bench's flags are
JAX's; ``cli serve-bench --device cpu --compare-sequential`` exits 0 with
its ``bit-identical`` line; the engine's request log and event stream fold
into the same summary in the port's and the JAX package's ``ServingStats``;
and ``examples.serve_lm`` serves a snapshot written by ``LMTrainer``."""

import argparse

import numpy as np
import pytest

from ddl_tpu.obs import serving as jserving
from ddl_tpu.serve import bench as jbench
from ddl_tpu_torch import cli
from ddl_tpu_torch.examples import serve_lm, train_lm
from ddl_tpu_torch.obs import events_path, read_events
from ddl_tpu_torch.obs import serving as tserving
from ddl_tpu_torch.serve import bench as tbench


def _events(n: int, seed: int = 0) -> list[dict]:
    """Decode events of several tenants, engines and runs, some cold, some
    with 0.0 or missing fields."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        e = {"kind": "decode", "ts": 1000.0 + float(rng.uniform(0, 50)),
             "dur": float(rng.exponential(0.5)), "queue_delay": float(rng.exponential(0.1)),
             "ttft": float(rng.exponential(0.05)), "tok_per_s": float(rng.uniform(10, 900)),
             "new_tokens": int(rng.integers(1, 64)), "prompt_len": int(rng.integers(1, 512)),
             "batch": int(rng.integers(1, 3)), "warm": bool(rng.integers(5)),
             "chips": 1, "engine": ("serve", None)[i % 2], "run": f"r{i % 3}"}
        if i % 7 == 0:
            e["queue_delay"] = 0.0
        if i % 11 == 0:
            del e["ttft"]
        if i % 3:
            e["tenant"] = ("acme", "bulk", "")[i % 3]
            e["priority_class"] = ("interactive", "batch", None)[i % 3]
        out.append(e)
    out.append({"kind": "serve_admit", "request_id": "x"})
    return out


@pytest.mark.parametrize("n,capacity", [(40, 4096), (700, 64)], ids=["exact", "compressed"])
def test_serving_stats_equal_to_jax(n, capacity):
    events = _events(n)
    got = tserving.ServingStats.from_events(events, capacity=capacity)
    want = jserving.ServingStats.from_events(events, capacity=capacity)
    assert got.summary() == want.summary()
    assert got.state_dict() == want.state_dict()
    assert (tserving.render_percentiles(got.summary()["percentiles"])
            == jserving.render_percentiles(want.summary()["percentiles"]))
    # merging per-stream stats, and a state round trip
    a = tserving.ServingStats.from_events(events[: n // 2], capacity=capacity)
    a.merge(tserving.ServingStats.from_state(
        tserving.ServingStats.from_events(events[n // 2:], capacity=capacity).state_dict()))
    ja = jserving.ServingStats.from_events(events[: n // 2], capacity=capacity)
    ja.merge(jserving.ServingStats.from_state(
        jserving.ServingStats.from_events(events[n // 2:], capacity=capacity).state_dict()))
    assert a.summary() == ja.summary()
    assert tserving.tenant_of({"tenant": ""}) == jserving.tenant_of({"tenant": ""}) == "default"


def test_digests_and_reservoir_equal_to_jax():
    rng = np.random.default_rng(3)
    xs = rng.lognormal(size=3000).tolist()
    t, j = tserving.TDigest(compression=32, exact_max=100), \
        jserving.TDigest(compression=32, exact_max=100)
    tq, jq = tserving.QuantileAccumulator(capacity=50, seed=1), \
        jserving.QuantileAccumulator(capacity=50, seed=1)
    for x in xs:
        for acc in (t, j, tq, jq):
            acc.add(x)
    for q in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
        assert t.quantile(q) == j.quantile(q) and tq.quantile(q) == jq.quantile(q)
    for x in (0.1, 1.0, 3.0, 50.0):
        assert t.rank(x) == j.rank(x)
    assert t.state_dict() == j.state_dict() and tq.summary() == jq.summary()
    # a reservoir's state migrates into a digest in both
    assert (tserving.TDigest.from_state(tq.state_dict()).summary()
            == jserving.TDigest.from_state(jq.state_dict()).summary())
    for bad in (dict(compression=4), dict(exact_max=0)):
        with pytest.raises(ValueError):
            tserving.TDigest(**bad)


SCENARIOS = ["none", "shared-prefix", "long-prompt", "bursty", "mixed", "multi-tenant"]


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 7])
def test_make_clients_equal_to_jax(scenario, seed):
    """Prompts, max_new, arrivals and tenant tags: the same traffic from the
    same --seed as the JAX bench."""
    class Cfg:
        vocab_size = 50304

    args = argparse.Namespace(seed=seed, clients=16, scenario=scenario, arrival_s=0.02,
                              shared_prefix_len=256, long_prompt_len=2048)
    got = tbench._make_clients(args, Cfg, 64, 512, 32, 64)
    want = jbench._make_clients(args, Cfg, 64, 512, 32, 64)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "prompt":
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k
    for s in ("8", "8:24"):
        assert tbench._parse_range(s, "x") == jbench._parse_range(s, "x")
    for bad in ("0", "9:3", "a", "1:2:3"):
        with pytest.raises(SystemExit):
            tbench._parse_range(bad, "x")


class _Parsed(Exception):
    pass


def test_flags_and_defaults_are_jax(monkeypatch):
    def flags(main):
        seen = {}

        def capture(self, *args, **kwargs):
            seen.update({a.dest: a.default for a in self._actions if a.dest != "help"})
            raise _Parsed

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            main([])
        monkeypatch.undo()
        return seen

    got, want = flags(tbench.main), flags(jbench.main)
    assert want.pop("cpu_devices") == 0
    assert got.pop("device") is None
    assert got == want


@pytest.mark.parametrize("flag", ["--data", "--model", "--seq"])
def test_mesh_flags_raise_item_11(flag):
    with pytest.raises(NotImplementedError, match=f"{flag} 2: .*ROADMAP item 11"):
        tbench.main(["--device", "cpu", flag, "2"])


def test_cli_serve_bench_compare_sequential(capsys, tmp_path):
    """The acceptance command: the report, the percentile table and the
    bit-identical line; its events fold into the report's percentiles in
    the JAX package's ServingStats too."""
    cli.main(["serve-bench", "--device", "cpu", "--clients", "8", "--prompt-len", "8:24",
              "--max-new", "16:32", "--compare-sequential", "--obs-log-dir",
              str(tmp_path), "--job-id", "sb"])
    out = capsys.readouterr().out
    for line in ("== serve-bench report ==", "completed: 8", "aggregate:",
                 "-- percentiles (warm requests) --", "latency_s", "ttft_s",
                 "token check: 8 completed request(s) bit-identical to the sequential replay",
                 "sequential baseline:"):
        assert line in out, line
    events = read_events(events_path(tmp_path, "sb"))
    got = tserving.ServingStats.from_events(events).summary()
    want = jserving.ServingStats.from_events(events).summary()
    assert got == want and got["requests"] == 8 and got["cold"] == 0


@pytest.mark.parametrize("scenario,extra", [
    ("shared-prefix", ["--shared-prefix-len", "24", "--prompt-len", "4:12", "--max-new", "6"]),
    ("long-prompt", ["--long-prompt-len", "96", "--prompt-len", "8:16", "--max-new", "5",
                     "--prefill-chunk", "32"]),
    ("multi-tenant", ["--prompt-len", "8:24", "--max-new", "8:12"]),
])
def test_scenarios_report_their_signal(capsys, tmp_path, scenario, extra):
    tbench.main(["--device", "cpu", "--clients", "8", "--scenario", scenario,
                 "--block-size", "8", "--num-blocks", "128", "--max-batch", "4",
                 "--compare-sequential", "--obs-log-dir", str(tmp_path), *extra])
    out = capsys.readouterr().out
    assert "bit-identical to the sequential replay" in out
    signal = {"shared-prefix": "prefix cache: 7 hit(s)",
              "long-prompt": "short-request queue delay",
              "multi-tenant": "-- per-tenant (warm requests) --"}[scenario]
    assert signal in out
    if scenario == "multi-tenant":
        assert (tmp_path / "by_job_id" / "serve-bench" / "slo.json").is_file()


def test_request_log_feeds_serving_stats():
    """The engine's in-memory request log is event-shaped: the port's and
    the JAX package's ServingStats build the same summary from it."""
    import torch

    from ddl_tpu_torch.models.transformer import LMConfig, TransformerLM, init_lm_weights
    from ddl_tpu_torch.serve import ServeEngine

    cfg = LMConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=8, head_dim=8, d_ff=256,
                   compute_dtype="float32")
    model = TransformerLM(cfg)
    init_lm_weights(model, 0)
    eng = ServeEngine(cfg, model.state_dict(), block_size=8, num_blocks=32, max_batch=2,
                      prefix_cache=False, device="cpu")
    eng.precompile(8, 4)
    from time import perf_counter

    t0 = perf_counter()
    for i in range(3):
        eng.submit(np.arange(1, 9, dtype=np.int32), 4, request_id=f"c{i}", submitted_at=t0)
    with torch.inference_mode():
        eng.run()
    got = tserving.ServingStats.from_events(eng.request_log).summary()
    assert got == jserving.ServingStats.from_events(eng.request_log).summary()
    assert got["requests"] == 3 and got["cold"] == 0
    assert got["percentiles"]["ttft_s"]["count"] == 3
    assert got["percentiles"]["queue_delay_s"]["count"] == 3


def test_serve_lm_serves_an_lm_trainer_snapshot(tmp_path, capsys):
    train_lm.main(["--steps", "6", "--batch", "4", "--seq-len", "16", "--log-every", "3",
                   "--save-every", "6", "--job-id", "sv", "--d-model", "32", "--layers", "2",
                   "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
                   "--log-dir", str(tmp_path / "logs")])
    capsys.readouterr()
    base = ["--checkpoint-dir", str(tmp_path / "ck"), "--job-id", "sv", "--step", "6",
            "--d-model", "32", "--layers", "2", "--heads", "8", "--device", "cpu",
            "--clients", "4", "--prompt-len", "6:10", "--max-new", "5"]
    serve_lm.main([*base, "--compare-sequential"])
    out = capsys.readouterr().out
    assert "completed: 4" in out and "bit-identical" in out
    serve_lm.main([*base, "--int8", "kv+w", "--prefix-cache", "off", "--compare-sequential"])
    assert "bit-identical" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--checkpoint-dir"):
        serve_lm.main(["--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="latest for job 'sv': 6"):
        serve_lm.main([*base[:5], "5", *base[6:]])
