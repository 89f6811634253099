"""The port's command line (ddl_tpu_torch/cli.py, config.parse_cli,
launch.py) against the JAX package's (ddl_tpu/cli.py): the same config
from the same arguments (the pipeline presets too), the same loud flag
errors, pod supervision started as the JAX command line starts it, the
refusals of what the port does not run yet with their ROADMAP items, the
``serve-bench`` subcommand, ``bootstrap`` joining
the world the environment describes, the tiny run of tests/test_cli.py
through both command lines to the same epoch loss, and the example
shims."""

import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

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
    "dp": ["--preset", "dp"],
    "dp-data-4": ["--preset", "dp", "--set", "mesh.data=4", "data.global_batch_size=60"],
    "pp": ["--preset", "pp"],
    "pp-1f1b": ["--preset", "pp", "--set", "train.pipeline_schedule=1f1b", "model.remat=false"],
    "dp_pp": ["--preset", "dp_pp"],
    "dp_pp-data-2": ["--preset", "dp_pp", "--set", "mesh.data=2", "data.global_batch_size=20"],
}
PortTrainer = port_train.Trainer
ROOT = Path(__file__).resolve().parents[1]
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


@pytest.mark.parametrize("n", [1, 2, 4])
def test_cpu_devices_flag_means_the_cpu(n, monkeypatch):
    """``--cpu-devices N`` runs on the CPU, N devices for the ranks of a
    ``dp`` world, with the JAX command line's config.  The JAX command
    line's ``force_cpu_devices(N)`` is recorded, not run: before this
    process's JAX backend starts it would set the device count of every
    later JAX test in the process to N."""
    import ddl_tpu.launch

    forced = []
    monkeypatch.setattr(ddl_tpu.launch, "force_cpu_devices", forced.append)
    argv = ["--preset", "dp", "--cpu-devices", str(n), "--set", f"mesh.data={n}",
            f"data.global_batch_size={15 * n}"]
    cfg, device = parse_cli(argv)
    assert device == "cpu"
    assert to_dict(cfg) == jax_to_dict(jax_parse_cli(argv))
    assert forced == [n]


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
def test_pod_supervision_starts_as_in_jax(argv, monkeypatch):
    """``--supervise --pod`` starts pod supervision of the same child
    command line, with the host count and id the JAX command line takes
    (the flags, else ``DDL_COORD_*``/``DDL_HOST_ID``/``DDL_NUM_PROCESSES``/
    ``DDL_PROCESS_ID``), the restart budget and ``--elastic``."""
    import ddl_tpu.supervisor as jax_supervisor
    import ddl_tpu_torch.supervisor as port_supervisor

    for name in ("DDL_COORD_HOSTS", "DDL_COORD_HOST", "DDL_HOST_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DDL_NUM_PROCESSES", "3")
    monkeypatch.setenv("DDL_PROCESS_ID", "2")
    calls = {}

    def fake(key):
        def supervise_pod_command(argv, coord_dir, host, n_hosts, **kw):
            calls[key] = (argv[2:], coord_dir, host, n_hosts, kw)
            return 0
        return supervise_pod_command

    monkeypatch.setattr(jax_supervisor, "supervise_pod_command", fake("jax"))
    monkeypatch.setattr(port_supervisor, "supervise_pod_command", fake("port"))
    for key, main in (("jax", jax_cli.main), ("port", cli.main)):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 0
    assert calls["jax"][0][0] == "ddl_tpu.cli" and calls["port"][0][0] == "ddl_tpu_torch.cli"
    assert calls["port"][1:] == calls["jax"][1:]
    want = (2, 3) if "--hosts" not in argv else (1, 2)
    assert calls["port"][2:4] == want
    assert calls["port"][4] == {"max_restarts": 5, "elastic": "--elastic" in argv}


def test_pod_supervision_without_hosts_fails_as_in_jax(tmp_path, monkeypatch):
    """No ``--hosts`` and no host count in the environment make a pod of
    one host: a host id past it fails as the JAX command line does, before
    any child starts."""
    for name in ("DDL_COORD_HOSTS", "DDL_COORD_HOST", "DDL_HOST_ID", "DDL_NUM_PROCESSES",
                 "DDL_PROCESS_ID", "DDL_FAULT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DDL_LOG_DIR", str(tmp_path / "logs"))
    errors = []
    for key, main in (("jax", jax_cli.main), ("port", cli.main)):
        with pytest.raises(ValueError) as e:
            main(["train", "--supervise", "--pod", str(tmp_path / key), "--host-id", "1"])
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "host 1 out of range for 1"


@pytest.mark.parametrize("name,item", [("pp", "item 8"), ("dp_pp", "item 8")])
def test_unported_presets_name_their_item(name, item):
    """The presets of ROADMAP item 8, refused until it was ported, are now
    the JAX package's configs, and the command line starts their worlds of
    ``mesh.data * mesh.pipe`` ranks: on one CPU device it refuses at once,
    naming the devices the mesh needs (the runs themselves are in
    test_torch_pp_trainer.py and the example shims below)."""
    from ddl_tpu.config import preset as jax_preset

    cfg = preset(name)
    assert to_dict(cfg) == jax_to_dict(jax_preset(name))
    assert cfg.mesh.num_devices == {"pp": 2, "dp_pp": 6}[name]
    with pytest.raises(ValueError, match=f"needs {cfg.mesh.num_devices} devices"):
        cli.main(["--preset", name, "--device", "cpu"])


@pytest.mark.parametrize("sub,reason", [("obs", "item 13"), ("bench", "item 13"),
                                        ("lint", "not ported")])
def test_unported_subcommands_exit_with_their_reason(sub, reason):
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "summarize", "job"])
    assert reason in str(e.value)
    if sub == "lint":
        assert "JAX" in str(e.value)


def test_serve_bench_subcommand_serves(capsys):
    """``serve-bench`` runs the serving engine's benchmark (its report and
    the sequential token check are in test_torch_serve_bench.py)."""
    cli.main(["serve-bench", "--device", "cpu", "--clients", "3", "--prompt-len", "6:9",
              "--max-new", "3", "--no-warmup", "--compare-sequential"])
    out = capsys.readouterr().out
    assert "completed: 3" in out
    assert "token check: 3 completed request(s) bit-identical" in out


JOIN = ("import json, os\n"
        "import torch.distributed as dist\n"
        "from ddl_tpu_torch.launch import bootstrap, world_info\n"
        "bootstrap('cpu')\n"
        "info = world_info('cpu')\n"
        "info['env_process_id'] = os.environ.get('DDL_PROCESS_ID')\n"
        "print('WORLD ' + json.dumps(info))\n")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("kind", ["coordinator", "num-processes", "multihost"])
def test_bootstrap_joins_the_world_the_environment_describes(kind, tmp_path):
    """Two processes join one gloo world from ``DDL_COORDINATOR``/
    ``DDL_NUM_PROCESSES``/``DDL_PROCESS_ID``, or through ``env://`` under
    ``DDL_MULTIHOST=1`` (where the rank becomes ``DDL_PROCESS_ID``, the
    events' host); ``DDL_NUM_PROCESSES`` alone names no coordinator and
    leaves each process a world of one, as in the JAX package."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if not k.startswith("DDL_")}
    base["PYTHONPATH"] = str(ROOT)
    procs = []
    for rank in range(2):
        env = dict(base, **{
            "coordinator": {"DDL_COORDINATOR": f"localhost:{port}", "DDL_NUM_PROCESSES": "2",
                            "DDL_PROCESS_ID": str(rank)},
            "num-processes": {"DDL_NUM_PROCESSES": "2"},
            "multihost": {"DDL_MULTIHOST": "1", "MASTER_ADDR": "localhost",
                          "MASTER_PORT": str(port), "RANK": str(rank), "WORLD_SIZE": "2"},
        }[kind])
        procs.append(subprocess.Popen([sys.executable, "-c", JOIN], env=env, cwd=tmp_path,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    infos = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        infos.append(json.loads(out.split("WORLD ", 1)[1]))
    if kind == "num-processes":
        assert [(i["process_index"], i["process_count"]) for i in infos] == [(0, 1), (0, 1)]
        assert "backend" not in infos[0]
        return
    assert sorted(i["process_index"] for i in infos) == [0, 1]
    assert {(i["process_count"], i["backend"], i["global_device_count"]) for i in infos} == {
        (2, "gloo", 2)}
    assert sorted(i["host_id"] for i in infos) == [0, 1]
    assert sorted(i["env_process_id"] for i in infos) == ["0", "1"]


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


@pytest.mark.parametrize("shim,item", [("pp", "item 8"), ("ddp_n_pp", "item 8")])
def test_example_shims_of_unported_presets_fail_at_once(shim, item, tmp_path, monkeypatch):
    """``examples/pp.py`` and ``examples/ddp_n_pp.py``, which failed at once
    until ROADMAP item 8 was ported, now train their presets: two gloo
    ranks (``pp``) or a (2, 2) mesh of four (``dp_pp``) on the CPU started
    by the command line, one set of CSV rows (rank 0's)."""
    devices, extra = {"pp": ("2", []), "ddp_n_pp": ("4", ["mesh.data=2"])}[shim]
    monkeypatch.setenv("DDL_JOB_ID", f"{shim}-shim")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setattr(sys, "argv", [
        f"{shim}.py", "--cpu-devices", devices, "--set", *TINY, *extra,
        "train.num_microbatches=2", f"train.log_dir={tmp_path}/logs",
        f"train.checkpoint_dir={tmp_path}/ckpt"])
    runpy.run_module(f"ddl_tpu_torch.examples.{shim}", run_name="__main__")
    rows = read_metric_csv(tmp_path / "logs" / "by_job_id" / f"{shim}-shim" / "loss.csv")
    assert [(r["global_rank"], r["epoch"]) for r in rows] == [(0, 0)]
    assert np.isfinite(rows[0]["value"])


def test_single_example_shim_trains(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_JOB_ID", "single-shim")
    monkeypatch.setattr(sys, "argv", [
        "single.py", "--device", "cpu", "--set", *TINY, f"train.log_dir={tmp_path}/logs",
        f"train.checkpoint_dir={tmp_path}/ckpt"])
    runpy.run_module("ddl_tpu_torch.examples.single", run_name="__main__")
    rows = read_metric_csv(tmp_path / "logs" / "by_job_id" / "single-shim" / "loss.csv")
    assert len(rows) == 1 and np.isfinite(rows[0]["value"])


def test_ddp_example_shim_trains(tmp_path, monkeypatch):
    """``examples/ddp.py`` runs the ``dp`` preset: two gloo ranks on the
    CPU started by the command line, one set of CSV rows (rank 0's)."""
    monkeypatch.setenv("DDL_JOB_ID", "ddp-shim")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setattr(sys, "argv", [
        "ddp.py", "--cpu-devices", "2", "--set", *TINY, f"train.log_dir={tmp_path}/logs",
        f"train.checkpoint_dir={tmp_path}/ckpt"])
    runpy.run_module("ddl_tpu_torch.examples.ddp", run_name="__main__")
    rows = read_metric_csv(tmp_path / "logs" / "by_job_id" / "ddp-shim" / "loss.csv")
    assert [(r["global_rank"], r["epoch"]) for r in rows] == [(0, 0)]
    assert np.isfinite(rows[0]["value"])
