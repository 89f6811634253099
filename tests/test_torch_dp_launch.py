"""The port's launcher and its tools for a world of ranks
(ddl_tpu_torch/launch.py, parallel/mesh.py, tools/smoke.py, bench/comm.py):
the spawner's exit codes (a preempted rank lets its peers finish, a failed
one ends them at once), the refusal of a world larger than the devices
present, ``tools.smoke`` against its closed form and ``bench.comm``'s
ping-pong rows in the reference's shape, at two gloo ranks on the CPU."""

import csv
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from ddl_tpu_torch import cli, launch
from ddl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from ddl_tpu_torch.supervisor import EXIT_PREEMPTED

ROOT = Path(__file__).resolve().parents[1]
# rank 1 exits with the code given, after a moment; rank 0 prints and
# waits (for a while, or for good)
EXITS = """
import os, sys, time
if os.environ["DDL_PROCESS_ID"] == "1":
    time.sleep(0.5)
    sys.exit(int(sys.argv[1]))
print("rank0", os.environ["DDL_COORDINATOR"], os.environ["DDL_NUM_PROCESSES"],
      os.environ["DDL_LOCAL_RANK"], flush=True)
time.sleep(float(sys.argv[2]))
sys.exit(int(sys.argv[3]))
"""


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("DDL_")}
    return dict(env, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))


@pytest.mark.parametrize("code,peer_sleep,peer_code,want", [
    (EXIT_PREEMPTED, 1.0, EXIT_PREEMPTED, EXIT_PREEMPTED),  # the peer finishes, 75
    (EXIT_PREEMPTED, 600.0, 0, EXIT_PREEMPTED),  # the peer outlives the grace: ended
    (3, 600.0, 0, 3),  # a crash ends the peer at once
], ids=["preempted-peer-finishes", "preempted-peer-ended", "crash-ends-peer"])
def test_spawner_returns_the_first_failure_and_ends_the_rest(code, peer_sleep, peer_code, want,
                                                             tmp_path, monkeypatch):
    monkeypatch.setattr(launch, "PREEMPT_GRACE_S", 3.0)
    t0 = time.monotonic()
    got = launch.spawn_local([sys.executable, "-c", EXITS, str(code), str(peer_sleep),
                              str(peer_code)], 2, env=_env(), log_dir=tmp_path)
    assert got == want
    assert time.monotonic() - t0 < 30
    line = (tmp_path / "rank0.log").read_text().split()
    assert line[0] == "rank0" and line[1].startswith("localhost:") and line[2:4] == ["2", "0"]


@pytest.mark.parametrize("code", [EXIT_PREEMPTED, 3], ids=["preempted", "crash"])
def test_spawner_returns_the_code_of_ranks_that_exit_together(code, tmp_path):
    """Every rank exits with ``code`` at one wall-clock instant, so one poll
    finds them all exited: the world's code is still theirs, not 0."""
    together = ("import sys, time; time.sleep(max(0.0, float(sys.argv[2]) - time.time())); "
                "sys.exit(int(sys.argv[1]))")
    assert launch.spawn_local([sys.executable, "-c", together, str(code), str(time.time() + 3)],
                              2, env=_env(), log_dir=tmp_path) == code


# a rank that checks that its coordinator's port is bound (by the spawner)
# before it joins the world through it and sums its rank over the world
JOIN = """
import os, socket, sys
import torch, torch.distributed as dist
from ddl_tpu_torch import launch
port = int(os.environ["DDL_COORDINATOR"].rsplit(":", 1)[1])
probe = socket.socket()
probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
try:
    probe.bind(("localhost", port))
    sys.exit(9)  # the address was free: the spawner let it go
except OSError:
    pass
finally:
    probe.close()
launch.bootstrap("cpu")
t = torch.tensor([float(dist.get_rank())])
dist.all_reduce(t)
dist.destroy_process_group()
sys.exit(0 if t.item() == 1.0 else 8)
"""


def test_spawner_holds_the_coordinator_address_until_the_world_ends(tmp_path):
    """The spawner hosts the world's store: the port it hands the ranks is
    already bound when they start (a rank that can bind it exits 9), and
    the ranks join through it as clients and sum over the world."""
    assert launch.spawn_local([sys.executable, "-c", JOIN], 2, env=_env(), log_dir=tmp_path,
                              timeout_s=120) == 0, (tmp_path / "rank0.log").read_text()


def test_a_coordinator_port_taken_by_another_process_fails_loudly(tmp_path, monkeypatch):
    """The forced collision: the port the store is given is held by another
    socket.  The spawner fails at once with the bind error and starts no
    rank, never hanging."""
    import socket

    host_store = launch.host_store
    with socket.socket() as other:
        other.bind(("localhost", 0))
        other.listen()
        taken = other.getsockname()[1]
        monkeypatch.setattr(launch, "host_store",
                            lambda port, world, host="localhost": host_store(taken, world, host))
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="EADDRINUSE|address already in use"):
            launch.spawn_local([sys.executable, "-c", JOIN], 2, env=_env(), log_dir=tmp_path,
                               timeout_s=60)
        assert time.monotonic() - t0 < 10
    assert not list(tmp_path.iterdir())  # no rank started


def test_spawner_returns_0_when_every_rank_does(tmp_path):
    assert launch.spawn_local([sys.executable, "-c", EXITS, "0", "0.1", "0"], 2, env=_env(),
                              log_dir=tmp_path) == 0


def test_spawner_ends_a_world_that_outlives_its_timeout(tmp_path):
    """A world blocked for good (rank 0 waits on a peer that waits too) is
    ended at ``timeout_s`` with ``timeout``'s 124."""
    t0 = time.monotonic()
    assert launch.spawn_local([sys.executable, "-c", "import time; time.sleep(600)"], 2,
                              env=_env(), log_dir=tmp_path, timeout_s=2.0) == 124
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("world,device,cpu_devices,match", [
    (2, "cpu", 0, "needs 2 devices.*has 1 CPU"),
    (4, "cpu", 2, "needs 4 devices.*has 2 CPU"),
    (2, "cuda:0", 0, "names one"),
    (2, None, 0, "CUDA device"),
])
def test_a_world_larger_than_the_devices_is_refused(world, device, cpu_devices, match):
    if device is None and torch.cuda.device_count() >= world:
        pytest.skip("this host has the GPUs")
    with pytest.raises(ValueError, match=match):
        launch.check_local_world(world, device, cpu_devices)


def test_the_command_line_refuses_before_starting_ranks(tmp_path):
    """``--preset dp`` on one CPU device: the JAX ``build_mesh``'s
    ValueError, raised by the command line before any rank starts."""
    with pytest.raises(ValueError, match="needs 2 devices"):
        cli.main(["--preset", "dp", "--device", "cpu", "--set", f"train.log_dir={tmp_path}"])


@pytest.mark.parametrize("entry,argv", [
    ("cli", ["--preset", "dp", "--cpu-devices", "1"]),
    ("smoke", ["--data", "2", "--cpu-devices", "1"]),
    ("comm", ["--ranks", "2", "--cpu-devices", "1"]),
])
def test_every_entry_point_counts_the_cpu_devices_alike(entry, argv, tmp_path, monkeypatch):
    """The command line, ``tools.smoke`` and ``bench.comm`` start their
    ranks through ``launch.run_as_world``: two ranks need two CPU devices
    (``--cpu-devices 2``) on each, and none starts a rank before the
    refusal."""
    from ddl_tpu_torch.bench import comm
    from ddl_tpu_torch.tools import smoke

    monkeypatch.setattr(launch, "spawn_local", lambda *a, **k: pytest.fail("a rank started"))
    main = {"cli": cli.main, "smoke": smoke.main, "comm": comm.main}[entry]
    with pytest.raises(ValueError, match="needs 2 devices.*has 1 CPU"):
        main(argv + (["--set", f"train.log_dir={tmp_path}"] if entry == "cli" else []))


def test_run_as_world_leaves_a_rank_to_its_caller(monkeypatch):
    """Inside a world, or for a world of one, nothing starts: the caller
    runs as its rank."""
    monkeypatch.setattr(launch, "spawn_local", lambda *a, **k: pytest.fail("a rank started"))
    assert launch.run_as_world("ddl_tpu_torch.cli", [], 1, "cpu", 1) is False
    monkeypatch.setenv("DDL_COORDINATOR", "localhost:1")
    assert launch.run_as_world("ddl_tpu_torch.cli", [], 4, "cpu", 1) is False


def test_build_mesh_needs_the_world_and_no_pipe():
    """A mesh needs one rank a device, the pipe axis's too (refused until
    ROADMAP item 8 was ported; a world of one cannot hold a (1, 2) mesh
    now, as it cannot hold a (2, 1) one); a world of one is its own
    mesh."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        build_mesh(MeshSpec(2, 1), "cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        build_mesh(MeshSpec(1, 2), "cpu")
    mesh = build_mesh(MeshSpec(1, 1), "cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.device) == (0, 1, None, torch.device("cpu"))
    assert (mesh.data_index, mesh.pipe_index, mesh.pipe_group) == (0, 0, None)
    assert mesh.agree(lambda: 7) == 7 and mesh.any(True) and not mesh.any(False)


def _run(module: str, *args, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env or _env(), capture_output=True, text=True, timeout=300)


def test_smoke_sums_over_each_axis_to_the_closed_form():
    proc = _run("ddl_tpu_torch.tools.smoke", "--data", "2", "--cpu-devices", "2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    # the ranks share the pipe, so their lines may interleave
    found = re.findall(r"\[smoke\] rank (\d): sums over 'data' and 'pipe' (\{[^}]*\}) "
                       r"\(closed form (\{[^}]*\})\): (OK|FAIL)", proc.stdout)
    assert sorted(f[0] for f in found) == ["0", "1"]
    assert all(got == want and verdict == "OK" and "'data': 1.0" in got
               for _, got, want, verdict in found)
    # the pipe axis (refused until ROADMAP item 8 was ported): a (2, 2)
    # mesh of four ranks, each axis summed over its own group
    proc = _run("ddl_tpu_torch.tools.smoke", "--data", "2", "--pipe", "2", "--cpu-devices", "4")
    assert proc.returncode == 0, proc.stderr[-3000:]
    found = re.findall(r"\[smoke\] rank (\d): sums over 'data' and 'pipe' (\{[^}]*\}) "
                       r"\(closed form (\{[^}]*\})\): (OK|FAIL)", proc.stdout)
    assert sorted(f[0] for f in found) == ["0", "1", "2", "3"]
    assert all(got == want and verdict == "OK" for _, got, want, verdict in found)
    assert any("'pipe': 5.0" in got for _, got, _, _ in found)


def test_comm_bench_rows_have_the_reference_shape(tmp_path):
    """The ping-pong's rows are ``job_id,iteration,elapsed_ms`` (reference
    communication_time.py), iterations 0..N, written once by rank 0; the
    summary has the ping-pong and each collective at each sweep payload."""
    env = dict(_env(), DDL_JOB_ID="comm-test")
    proc = _run("ddl_tpu_torch.bench.comm", "--ranks", "2", "--cpu-devices", "2",
                "--iterations", "4", "--payload-elems", "256", "--sweep-iterations", "2",
                "--log-dir", str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "communication_time.csv") as f:
        rows = list(csv.reader(f))
    assert [(r[0], int(r[1])) for r in rows] == [("comm-test", i) for i in range(5)]
    assert all(float(r[2]) > 0 for r in rows)
    summary = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert summary["devices"] == 2 and summary["backend"] == "gloo"
    assert summary["ping_pong_mean_ms"] > 0 and summary["ping_pong_one_way_gbps"] > 0
    assert {(r["op"], r["devices"]) for r in summary["sweep"]} == {
        ("all_reduce", 2), ("all_gather", 2)}
    assert len(summary["sweep"]) == 2 * 6
    assert all(r["algbw_gbps"] > 0 for r in summary["sweep"])
