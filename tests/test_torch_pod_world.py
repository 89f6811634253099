"""The slice's main path on the CPU: a ``dp`` DenseNet world over the hosts
of a pod (ddl_tpu_torch/launch.py ``run_pod_host``, cli.py ``train
--supervise --pod``, bench/pod.py).

Each host's launcher starts its share of one world, whose store the
leader hosts and publishes for the restart epoch; hosts that disagree on
their share, or survivors whose devices no longer hold the mesh, fail
before any rank starts.  ``bench/pod.py``'s crash drill through the
command line, at one and at two gloo ranks a host with host 1 crashing in
epoch 2: both hosts relaunch in one restart epoch, resume the agreed
snapshot, run exactly the steps from its cursor, and end bit-equal to the
whole pod (the final parameters and BatchNorm statistics, each epoch's
rows).  Every wait has its own time limit.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from ddl_tpu_torch.bench import pod as bench_pod
from ddl_tpu_torch.coord import Rendezvous

ROOT = Path(__file__).resolve().parents[1]
TINY = ("model.growth_rate=4", "model.block_config=[2,2]", "model.num_init_features=8",
        "model.bn_size=2", "data.image_size=16", "model.compute_dtype=float32",
        "model.dense_block_impl=packed", "model.pallas_normalize=false", "data.num_workers=0")


def _clean_env() -> dict:
    return {k: v for k, v in os.environ.items()
            if not k.startswith("DDL_") and k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}


def _pod_env(root: Path, host: int, n_hosts: int, members: str | None = None) -> dict:
    env = dict(_clean_env(), OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
               DDL_COORD_DIR=str(root), DDL_COORD_HOSTS=str(n_hosts), DDL_COORD_HOST=str(host),
               DDL_RESTART_EPOCH="0", DDL_COORD_TIMEOUT_S="60")
    if members:
        env["DDL_COORD_MEMBERS"] = members
    return env


@pytest.mark.parametrize("devices,cpu_devices", [(["0", "0"], "1"), (["0,1", "2,3"], "2")],
                         ids=["one-rank-a-host", "two-ranks-a-host"])
def test_dp_pod_crash_resumes_bit_equal_to_the_whole_pod(devices, cpu_devices, tmp_path,
                                                        monkeypatch):
    """``bench/pod.py``'s drill on the CPU (the whole pod beside the crashed
    one): every check but the kernels' launch counts, which the CPU's
    plain versions leave at 0, and bit-equality."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = bench_pod.crash_drill(tmp_path, devices, 4, "gloo",
                                (*TINY, "--device", "cpu", "--cpu-devices", cpu_devices),
                                together=True, log=lambda m: None)
    failed = [what for what, ok in out["checks"] if not ok
              and "#1-#3" not in what and "backward kernel" not in what]
    assert not failed, (failed, out)
    assert out["world"] == 2 * int(cpu_devices) and out["bit_equal"], out
    assert out["record"]["reason"].endswith("crash") and out["record"]["crashes"] == 1
    assert out["agreed_resume"] in (None, 0)
    for h, r in out["restart"].items():
        assert r["restart_latency_s"] > r["to_run_start_s"] > 0, (h, r)
    for tags in out["launches"].values():
        assert all(set(n) == {"normalize", "fused_dense_block", "fused_dense_block_bwd"}
                   for n in tags.values())


def test_two_hosts_of_two_ranks_form_one_world(tmp_path):
    """Two launchers (``tools.smoke --data 4`` under the pod's environment)
    each start two gloo ranks; the four join the leader's store as ranks
    0-3 (host 1's local rank l at global rank 2 + l), and every rank's sum
    over the data axis is the closed form's."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ddl_tpu_torch.tools.smoke", "--data", "4", "--cpu-devices",
         "2"], cwd=ROOT, env=_pod_env(tmp_path, h, 2), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for h in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    for h, out in enumerate(outs):
        assert f"global ranks {2 * h}..{2 * h + 1} of 4" in out, out
    found = re.findall(r"\[smoke\] rank (\d): sums over 'data' and 'pipe' (\{[^}]*\}) "
                       r"\(closed form (\{[^}]*\})\): (OK|FAIL)", "".join(outs))
    assert sorted(f[0] for f in found) == ["0", "1", "2", "3"], outs
    assert all(got == want and verdict == "OK" and "'data': 6.0" in got
               for _, got, want, verdict in found)
    agreed = Rendezvous(tmp_path, 1, 2).agree("coordinator-e0", lambda: None, timeout_s=1)
    assert (agreed["world"], agreed["local"], agreed["hosts"]) == (4, 2, [0, 1])


def test_hosts_that_disagree_on_their_ranks_fail_before_any_rank_starts(tmp_path, monkeypatch):
    """The leader published a world of 4 at 2 ranks a host; a host whose own
    config makes it 1 of 2 refuses loudly, starting nothing."""
    from ddl_tpu_torch import launch

    Rendezvous(tmp_path, 0, 2).agree("coordinator-e0", lambda: {
        "world": 4, "local": 2, "hosts": [0, 1], "coordinator": "localhost:1"})
    for k, v in _pod_env(tmp_path, 1, 2).items():
        if k.startswith("DDL_"):
            monkeypatch.setenv(k, v)
    for k in ("DDL_LOCAL_RANK", "DDL_COORDINATOR", "DDL_COORD_MEMBERS"):
        monkeypatch.delenv(k, raising=False)
    started = []
    monkeypatch.setattr(launch, "spawn_local", lambda *a, **k: started.append(a) or 0)
    with pytest.raises(ValueError, match="would start 1 of 2 ranks"):
        launch.run_as_world("ddl_tpu_torch.cli", [], 2, "cpu", 1)
    assert not started and "DDL_LOCAL_RANK" not in os.environ


def test_a_shrunk_pod_refuses_the_dp_mesh_in_the_jax_words(tmp_path, monkeypatch):
    """After an elastic scale-down to host 0 alone, the ``dp`` mesh of 2
    no longer fits the survivor's one device: refused before any rank
    starts, in the words the JAX package's ``build_mesh`` refuses it with
    (its survivors' world has one device fewer)."""
    import jax

    from ddl_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ddl_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from ddl_tpu_torch import launch
    from ddl_tpu_torch.parallel.mesh import MeshSpec

    with pytest.raises(ValueError) as want:
        jax_build_mesh(JaxMeshSpec(2, 1), jax.devices()[:1])
    for k, v in _pod_env(tmp_path, 0, 2, members="0").items():
        if k.startswith("DDL_"):
            monkeypatch.setenv(k, v)
    for k in ("DDL_LOCAL_RANK", "DDL_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError) as got:
        launch.run_as_world("ddl_tpu_torch.cli", [], 2, "cpu", 1, MeshSpec(2, 1))
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]
    assert not (tmp_path / "agree").exists()  # no world was published
