"""The port's command line (ddl_tpu_torch/cli.py, config.parse_cli,
launch.py) against the JAX package's (ddl_tpu/cli.py): the same config
from the same arguments, the same loud flag errors, the refusals of what
the port does not run yet with their ROADMAP items, the tiny run of
tests/test_cli.py through both command lines to the same epoch loss, and
the example shims."""

import runpy
import sys

import jax
import numpy as np
import pytest

import ddl_tpu.train as jax_train
import ddl_tpu_torch.train as port_train
from ddl_tpu import cli as jax_cli
from ddl_tpu.config import parse_cli as jax_parse_cli
from ddl_tpu.config import to_dict as jax_to_dict
from ddl_tpu.launch import world_info as jax_world_info
from ddl_tpu.utils.csv_logger import read_metric_csv
from ddl_tpu_torch import cli
from ddl_tpu_torch.config import parse_cli, preset, to_dict
from ddl_tpu_torch.launch import bootstrap, world_info
from ddl_tpu_torch.models.convert import from_jax_train_state

CASES = {
    "defaults": [],
    "tuple": ["--set", "model.block_config=[2,2]", "model.dense_block_fused_blocks=[0]"],
    "bools": ["--set", "train.async_checkpoint=false", "data.shuffle=no",
              "model.pallas_normalize=on", "train.auto_resume=0"],
    "floats": ["--set", "train.learning_rate=3e-4", "train.nan_grace_scale=0.5",
               "train.eps=1e-7"],
    "none-fields": ["--set", "train.snapshot_epoch=3", "train.snapshot_job_id=job7",
                    "model.pretrained_path=null", "train.profile_dir=/tmp/prof"],
    "strings-and-ints": ["--preset", "single", "--set", "data.dataset_dir=/data/aptos",
                         "model.compute_dtype=bfloat16", "model.dense_block_impl=fused",
                         "data.global_batch_size=20", "train.max_epochs=7"],
    "print-config": ["--print-config", "--set", "train.max_epochs=3", "data.image_size=32"],
}
PortTrainer = port_train.Trainer
# tests/test_cli.py's tiny run
TINY = ["model.growth_rate=4", "model.block_config=[2,2]", "model.num_init_features=8",
        "model.bn_size=2", "model.split_blocks=[1]", "model.remat=false", "data.image_size=16",
        "data.synthetic_num_train=32", "data.synthetic_num_test=16", "data.global_batch_size=8",
        "data.eval_batch_size=8", "data.num_workers=0", "train.max_epochs=1"]


@pytest.mark.parametrize("argv", CASES.values(), ids=CASES.keys())
def test_parse_cli_gives_the_jax_config(argv, capsys):
    want = jax_to_dict(jax_parse_cli(argv))
    jax_printed = capsys.readouterr().out
    cfg, device = parse_cli(argv)
    assert to_dict(cfg) == want
    assert capsys.readouterr().out == jax_printed
    assert device is None


@pytest.mark.parametrize("field", ["model.nope", "train.bogus", "data.imagesize"])
def test_unknown_field_raises_key_error_in_both(field):
    with pytest.raises(KeyError, match=field):
        jax_parse_cli(["--set", f"{field}=1"])
    with pytest.raises(KeyError, match=field):
        parse_cli(["--set", f"{field}=1"])


def test_unknown_preset_is_an_argparse_choice_in_both(capsys):
    for parse in (jax_parse_cli, parse_cli):
        with pytest.raises(SystemExit):
            parse(["--preset", "zero"])
        assert "invalid choice: 'zero'" in capsys.readouterr().err


@pytest.mark.parametrize("argv,device", [(["--device", "cpu"], "cpu"),
                                         (["--device", "cuda:1"], "cuda:1"),
                                         (["--cpu-devices", "1"], "cpu"), ([], None)])
def test_device_flag(argv, device):
    assert parse_cli(argv)[1] == device


def test_more_than_one_cpu_device_names_item_7():
    with pytest.raises(NotImplementedError, match="item 7"):
        parse_cli(["--cpu-devices", "2"])


@pytest.mark.parametrize("argv", [["--max-restarts", "2"], ["--pod", "/nas/coord"],
                                  ["--hosts", "2"], ["--host-id", "1"], ["--elastic"],
                                  ["train", "--elastic", "--supervise"]],
                         ids=["max-restarts", "pod", "hosts", "host-id", "elastic",
                              "elastic-supervised"])
def test_flag_consistency_errors_match_jax(argv):
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv)
    assert str(got.value) == str(want.value)
    assert "require" in str(got.value)


@pytest.mark.parametrize("argv", [["--supervise", "--pod", "/nas/coord"],
                                  ["train", "--supervise", "--pod", "d", "--hosts", "2",
                                   "--host-id", "1", "--elastic"]],
                         ids=["pod", "elastic-pod"])
def test_pod_supervision_names_item_7(argv):
    with pytest.raises(NotImplementedError, match="item 7"):
        cli.main(argv)


@pytest.mark.parametrize("name,item", [("dp", "item 7"), ("pp", "item 8"),
                                       ("dp_pp", "items 7 and 8")])
def test_unported_presets_name_their_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        preset(name)
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["--preset", name, "--device", "cpu"])


@pytest.mark.parametrize("sub,reason", [("obs", "item 13"), ("bench", "item 13"),
                                        ("serve-bench", "item 12"), ("lint", "not ported")])
def test_unported_subcommands_exit_with_their_reason(sub, reason):
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "summarize", "job"])
    assert reason in str(e.value)
    if sub == "lint":
        assert "JAX" in str(e.value)


@pytest.mark.parametrize("env", [{"DDL_COORDINATOR": "host0:1234"}, {"DDL_NUM_PROCESSES": "2"},
                                 {"DDL_MULTIHOST": "1"}],
                         ids=["coordinator", "num-processes", "multihost"])
def test_bootstrap_refuses_a_multi_process_world(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="item 7"):
        bootstrap()


def test_bootstrap_is_a_no_op_for_one_process(monkeypatch):
    for k in ("DDL_COORDINATOR", "DDL_MULTIHOST"):
        monkeypatch.setenv(k, "")
    monkeypatch.setenv("DDL_NUM_PROCESSES", "1")
    bootstrap()


def test_world_info_has_the_jax_keys(monkeypatch):
    monkeypatch.setenv("DDL_HOST_ID", "3")
    monkeypatch.setenv("DDL_RESTART_EPOCH", "2")
    info = world_info("cpu")
    assert info.keys() == jax_world_info().keys()
    assert info == {"process_index": 0, "process_count": 1, "host_id": 3, "restart_epoch": 2,
                    "local_devices": ["cpu"], "global_device_count": 1, "platform": "cpu"}


def test_no_device_means_cuda_and_raises_without_it(tmp_path):
    """``--device`` omitted: the run is on CUDA, and this CPU-only host
    refuses it before any training."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--preset", "single", "--set", *TINY, f"train.log_dir={tmp_path}/logs",
                  f"train.checkpoint_dir={tmp_path}/ckpt"])


def test_tiny_run_matches_the_jax_command_line(tmp_path, monkeypatch):
    """tests/test_cli.py's run through both command lines, the port's Trainer
    starting from the JAX Trainer's initial state: the same epoch loss
    within rtol 1e-4 (test_torch_resume_obs's tolerance against the JAX
    Trainer), and both CSVs written."""
    initial = {}

    class JaxTrainer(jax_train.Trainer):
        def __init__(self, cfg):
            super().__init__(cfg)
            initial["state"] = jax.device_get(self.state)

    def port_trainer(cfg, device=None):
        t = PortTrainer(cfg, device=device)
        t.load_state(from_jax_train_state(initial["state"],
                                          [k for k, _ in t.model.named_parameters()]))
        return t

    monkeypatch.setenv("DDL_JOB_ID", "single-clitest")
    runs = {}
    for name, main, patch, extra in (("jax", jax_cli.main, (jax_train, JaxTrainer), []),
                                     ("port", cli.main, (port_train, port_trainer),
                                      ["--device", "cpu"])):
        with monkeypatch.context() as m:
            m.setattr(patch[0], "Trainer", patch[1])
            main(["--preset", "single", "--set", *TINY, f"train.log_dir={tmp_path}/{name}/logs",
                  f"train.checkpoint_dir={tmp_path}/{name}/ckpt", *extra])
        job = tmp_path / name / "logs" / "by_job_id" / "single-clitest"
        runs[name] = {m: read_metric_csv(job / f"{m}.csv") for m in ("loss", "steps_per_sec")}
    for name, rows in runs.items():
        assert len(rows["loss"]) == 1 and np.isfinite(rows["loss"][0]["value"]), name
        assert rows["steps_per_sec"][0]["value"] > 0, name
    np.testing.assert_allclose(runs["port"]["loss"][0]["value"], runs["jax"]["loss"][0]["value"],
                               rtol=1e-4)


@pytest.mark.parametrize("shim,item", [("ddp", "item 7"), ("pp", "item 8"),
                                       ("ddp_n_pp", "items 7 and 8")])
def test_example_shims_of_unported_presets_fail_at_once(shim, item, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{shim}.py"])
    with pytest.raises(NotImplementedError, match=item):
        runpy.run_module(f"ddl_tpu_torch.examples.{shim}", run_name="__main__")


def test_single_example_shim_trains(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_JOB_ID", "single-shim")
    monkeypatch.setattr(sys, "argv", [
        "single.py", "--device", "cpu", "--set", *TINY, f"train.log_dir={tmp_path}/logs",
        f"train.checkpoint_dir={tmp_path}/ckpt"])
    runpy.run_module("ddl_tpu_torch.examples.single", run_name="__main__")
    rows = read_metric_csv(tmp_path / "logs" / "by_job_id" / "single-shim" / "loss.csv")
    assert len(rows) == 1 and np.isfinite(rows[0]["value"])
