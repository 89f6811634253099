"""The port's LM entry points (ddl_tpu_torch/examples/train_lm.py and
generate_lm.py) on the CPU: the JAX scripts' flags with their defaults
(``--device`` in place of ``--cpu-devices``); ``train_lm`` trains with
snapshots and a relaunch resumes; ``generate_lm`` decodes the snapshot in
each ``--int8`` mode, from a text prompt and with sampling; the mesh flags
above 1 raise naming ROADMAP item 11, and ``--zero`` is the JAX
package's no-op at data 1; ``--obs-log-dir`` writes the decode
telemetry."""

import argparse
import csv

import pytest
import torch

import examples.generate_lm as jax_generate_lm
import examples.train_lm as jax_train_lm
from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.examples import generate_lm, train_lm
from ddl_tpu_torch.obs import events_path, read_events

TINY = ["--d-model", "32", "--layers", "2", "--device", "cpu"]
TRAIN = ["--steps", "12", "--batch", "4", "--seq-len", "16", "--log-every", "3",
         "--save-every", "6", "--job-id", "ex", *TINY]


class _Parsed(Exception):
    pass


def _flags(main, monkeypatch) -> dict:
    """``{dest: default}`` of the parser ``main`` builds (caught at its
    ``parse_args``)."""
    seen = {}

    def capture(self, *args, **kwargs):
        seen.update({a.dest: a.default for a in self._actions if a.dest != "help"})
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main()
    return seen


@pytest.mark.parametrize("port, jax_main", [(train_lm.main, jax_train_lm.main),
                                            (generate_lm.main, jax_generate_lm.main)],
                         ids=["train_lm", "generate_lm"])
def test_flags_and_defaults_are_jax(port, jax_main, monkeypatch):
    got, want = _flags(port, monkeypatch), _flags(jax_main, monkeypatch)
    assert want.pop("cpu_devices") == 0
    assert got.pop("device") is None
    assert got == want


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("examples")
    train_lm.main([*TRAIN, "--checkpoint-dir", str(root / "ck"),
                   "--log-dir", str(root / "logs")])
    return root


def test_train_lm_trains_and_saves(trained):
    assert ckpt.snapshot_epochs(trained / "ck", "ex") == [6, 12]
    with open(trained / "logs" / "by_job_id" / "ex" / "loss.csv", newline="") as f:
        rows = [(int(r[5]), float(r[6])) for r in csv.reader(f)]
    assert [s for s, _ in rows] == [3, 6, 9, 12] and rows[-1][1] < rows[0][1]
    assert (trained / "logs" / "by_job_id" / "ex" / "events-h000.jsonl").is_file()


def test_train_lm_relaunch_resumes_on_a_corpus(tmp_path, capsys):
    text = tmp_path / "corpus.txt"
    text.write_bytes(bytes(range(256)) * 12)
    run = [*TRAIN, "--corpus", str(text), "--eval-every", "3", "--eval-frac", "0.2",
           "--checkpoint-dir", str(tmp_path / "ck"), "--log-dir", ""]
    train_lm.main(run)
    assert "heldout: ce" in capsys.readouterr().out
    train_lm.main([*run, "--steps", "15"])
    out = capsys.readouterr().out
    assert "resumed from step 12" in out and "3 steps in" in out
    assert ckpt.latest_epoch(tmp_path / "ck", "ex") == 15
    train_lm.main([*run, "--steps", "3", "--fresh", "--job-id", "ex"])
    assert "resumed" not in capsys.readouterr().out


@pytest.mark.parametrize("int8", ["none", "kv", "kv+w"])
def test_generate_lm_decodes_the_snapshot(trained, int8, capsys):
    generate_lm.main(["--checkpoint-dir", str(trained / "ck"), "--job-id", "ex", "--step",
                      "12", "--max-new", "5", "--int8", int8, *TINY])
    out = capsys.readouterr().out
    assert "loaded step 12" in out and "top-8 chain transition" in out
    assert out.count(" -> [") == 2  # --batch 2


def test_generate_lm_text_prompt_and_sampling(trained, capsys):
    base = ["--checkpoint-dir", str(trained / "ck"), "--job-id", "ex", "--step", "12",
            "--max-new", "5", "--prompt-text", "def main():", *TINY]
    generate_lm.main([*base, "--temperature", "0.8", "--top-k", "5", "--seed", "1"])
    first = capsys.readouterr().out
    assert "keeping the LAST 8 of 11 prompt bytes" in first
    assert first.count("' main():' -> ") == 2  # the last 8 bytes, --batch 2
    generate_lm.main([*base, "--temperature", "0.8", "--top-k", "5", "--seed", "1"])
    assert capsys.readouterr().out == first  # seeded
    with pytest.raises(FileNotFoundError, match="latest for job 'ex': 12"):
        generate_lm.main([*base, "--step", "7"])


@pytest.mark.parametrize("flag", ["--data", "--seq", "--model", "--expert-axis", "--pipe",
                                  "--microbatches"])
def test_train_lm_mesh_flags_raise_item_11(flag):
    with pytest.raises(NotImplementedError, match=f"{flag} 2: .*ROADMAP item 11"):
        train_lm.main([*TRAIN, flag, "2"])


@pytest.mark.parametrize("flag", ["--data", "--model"])
def test_generate_lm_mesh_flags_raise_item_11(flag):
    with pytest.raises(NotImplementedError, match=f"{flag} 4: .*ROADMAP item 11"):
        generate_lm.main(["--checkpoint-dir", "ck", "--step", "1", flag, "4", *TINY])


def test_zero_and_decode_telemetry_raise_their_items(trained, capsys):
    """``--zero`` (refused until ROADMAP item 9 was ported) is the JAX
    package's no-op on the one-device mesh: the run's last snapshot is
    bit-equal to the same run's without it.  The decode telemetry is
    ported: ``--obs-log-dir`` writes each request's ``decode`` event (the
    first cold, the rest warm) and its trace spans, which the JAX
    package's ``ServingStats`` folds into percentiles."""
    from ddl_tpu.obs.serving import ServingStats as JaxServingStats

    train_lm.main([*TRAIN, "--zero", "--checkpoint-dir", str(trained / "ck-zero"),
                   "--log-dir", ""])
    zero, _ = ckpt.load_snapshot(trained / "ck-zero", "ex", 12)
    plain, _ = ckpt.load_snapshot(trained / "ck", "ex", 12)
    assert zero["model"].keys() == plain["model"].keys()
    for k, v in plain["model"].items():
        assert torch.equal(zero["model"][k], v), k
    logs = trained / "decode-logs"
    generate_lm.main(["--checkpoint-dir", str(trained / "ck"), "--job-id", "ex", "--step", "12",
                      "--max-new", "4", "--requests", "3", "--obs-log-dir", str(logs), *TINY])
    capsys.readouterr()
    events = read_events(events_path(logs, "ex"))
    decodes = [e for e in events if e["kind"] == "decode"]
    assert [e["warm"] for e in decodes] == [False, True, True]
    assert all(e["new_tokens"] == 4 and e["batch"] == 2 and e["ttft"] <= e["dur"]
               for e in decodes)
    assert decodes[1]["queue_delay"] >= 0.0
    spans = [e for e in events if e["kind"] == "trace_span"]
    assert {e["name"] for e in spans} >= {"request", "prefill", "decode"}
    assert {e["name"] for e in events if e["kind"] == "span"} >= {
        "decode_request", "dispatch", "wait", "first_token"}
    summary = JaxServingStats.from_events(events).summary()
    assert summary["requests"] == 3 and summary["cold"] == 1
    assert summary["percentiles"]["ttft_s"]["count"] == 2


def test_device_none_means_cuda():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_lm.main(TRAIN[:-2])
        with pytest.raises(RuntimeError, match="CUDA"):
            generate_lm.main(["--checkpoint-dir", "ck", "--step", "1"])
