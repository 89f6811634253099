"""Launch helpers: join the world, start the local ranks (counterpart of
``ddl_tpu/launch.py``).

A data- or pipeline-parallel run is one process per device, each a rank
of one ``torch.distributed`` world.  ``bootstrap()`` joins that world from the
environment, as the JAX package's joins its coordinator:

* ``DDL_COORDINATOR`` (``host:port``), ``DDL_NUM_PROCESSES`` and
  ``DDL_PROCESS_ID``: a TCP rendezvous at that address;
* ``DDL_MULTIHOST=1``: ``env://``, the ``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK`` and ``WORLD_SIZE`` that cluster launchers set (the counterpart
  of JAX's auto-detection);
* neither: one process, nothing to join.

The backend is NCCL for a rank on a CUDA device and gloo on the CPU, and
the handshake is retried with the JAX package's backoff.  ``spawn_local``
starts the ranks of a one-host world (the command line's ``dp``, ``pp``
and ``dp_pp`` presets do this when no world is set in the environment):
each gets the ``DDL_*`` variables of its rank, and the spawner waits on
all of them.
The first rank to fail ends the others and its exit code is the
spawner's, so a dead rank never leaves its peers blocked in a collective,
and a preemption's ``EXIT_PREEMPTED`` reaches the supervisor, which
relaunches the whole world.  Pod supervision across hosts (a shared
rendezvous directory, elastic membership) is ROADMAP item 7b.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

__all__ = [
    "bootstrap",
    "check_local_world",
    "host_id",
    "in_world",
    "local_rank",
    "rank_device",
    "resolve_rank_device",
    "restart_epoch",
    "run_as_world",
    "spawn_local",
    "world_info",
]

# How long the spawner lets the other ranks finish after one exits with
# EXIT_PREEMPTED (they stop after the same step and exit alike) before it
# ends them.
PREEMPT_GRACE_S = 120.0
# How often the spawner looks at its ranks.
POLL_S = 0.05


def restart_epoch() -> int:
    """The pod restart epoch this process was launched under
    (``DDL_RESTART_EPOCH``; 0 for the first launch and every run outside
    a pod)."""
    try:
        return int(os.environ.get("DDL_RESTART_EPOCH") or 0)
    except ValueError:
        return 0


def host_id() -> int:
    """This process's index for telemetry: the launcher's ``DDL_HOST_ID``
    or ``DDL_PROCESS_ID``, else the rank in the world, else 0."""
    env = os.environ.get("DDL_HOST_ID") or os.environ.get("DDL_PROCESS_ID")
    if env:
        return int(env)
    return dist.get_rank() if dist.is_initialized() else 0


def in_world() -> bool:
    """Whether the environment describes a world to join."""
    return bool(os.environ.get("DDL_COORDINATOR")) or os.environ.get("DDL_MULTIHOST") == "1"


def local_rank() -> int:
    """This rank's index on its host: ``DDL_LOCAL_RANK``, the cluster
    launcher's ``LOCAL_RANK``, else the rank (one host)."""
    for name in ("DDL_LOCAL_RANK", "LOCAL_RANK", "DDL_PROCESS_ID", "RANK"):
        if os.environ.get(name):
            return int(os.environ[name])
    return 0


def rank_device(local: int | None = None) -> torch.device:
    """``cuda:<local rank>``: each rank of a host on a device of its own.
    Raises ``RuntimeError`` without CUDA and ``ValueError`` when the host
    has fewer GPUs than the rank needs."""
    local = local_rank() if local is None else local
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    have = torch.cuda.device_count()
    if local >= have:
        raise ValueError(f"local rank {local} needs cuda:{local}; this host has {have} GPU(s)")
    return torch.device("cuda", local)


def resolve_rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` where it names one (``"cpu"``,
    ``"cuda:1"``); ``cuda:<local rank>`` for None or a bare ``"cuda"`` in a
    world of several ranks; CUDA (``utils.device.resolve_device``) in one
    process."""
    from ddl_tpu_torch.utils.device import resolve_device

    several = in_world() or (dist.is_initialized() and dist.get_world_size() > 1)
    if several and (device is None or torch.device(device) == torch.device("cuda")):
        return rank_device()
    return resolve_device(device)


def check_local_world(world: int, device=None, cpu_devices: int = 0) -> None:
    """Refuse a one-host world of ``world`` ranks that the devices cannot
    hold, one rank per device, before any rank starts: CUDA devices
    (``device`` None or ``"cuda"``), or the ``cpu_devices`` CPU devices of
    ``--cpu-devices`` (one with ``device="cpu"`` alone).  A ``device``
    with an index names one device, which cannot hold several ranks."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        have, what = max(cpu_devices, 1), "CPU device(s) (--cpu-devices N)"
    elif device.index is not None:
        raise ValueError(f"a world of {world} ranks puts each on its own device; "
                         f"--device {device} names one (pass --device cuda)")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        what = "CUDA device(s)"
    if world > have:
        raise ValueError(f"the mesh needs {world} devices, one a rank; this host has "
                         f"{have} {what}")


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def bootstrap(
    device=None,
    backend: str | None = None,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    init_retries: int | None = None,
) -> None:
    """Join the world the environment describes; a no-op in one process
    and when this process has joined already.

    Explicit arguments win over ``DDL_COORDINATOR``/``DDL_NUM_PROCESSES``/
    ``DDL_PROCESS_ID``; ``DDL_MULTIHOST=1`` joins through ``env://``.
    ``device`` is this rank's device (default ``cuda:<local rank>``), which
    becomes the current CUDA device; ``backend`` defaults to NCCL for a
    CUDA device and gloo for the CPU, and is given explicitly only where
    several ranks share one card (NCCL refuses that).  A failed handshake
    (``RuntimeError``, ``OSError``) is retried ``init_retries`` times
    (default 3, ``DDL_INIT_RETRIES``) with exponential backoff and jitter,
    as in the JAX package; a ``ValueError`` (a misconfigured world) fails
    at once."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("DDL_COORDINATOR")
    if num_processes is None and os.environ.get("DDL_NUM_PROCESSES"):
        num_processes = int(os.environ["DDL_NUM_PROCESSES"])
    if process_id is None and os.environ.get("DDL_PROCESS_ID"):
        process_id = int(os.environ["DDL_PROCESS_ID"])
    if init_retries is None:
        init_retries = int(os.environ.get("DDL_INIT_RETRIES", "3"))
    multihost = os.environ.get("DDL_MULTIHOST") == "1"
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("DDL_COORDINATOR needs DDL_NUM_PROCESSES and DDL_PROCESS_ID")
        kwargs = dict(init_method=_init_method(coordinator_address),
                      world_size=num_processes, rank=process_id)
    elif multihost:
        kwargs = dict(init_method="env://")
    else:
        return

    device = resolve_rank_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)

    from ddl_tpu_torch.utils.backoff import Backoff, retry_with_backoff

    def note(e, attempt):
        print(f"[ddl_tpu_torch] init_process_group failed ({e}); "
              f"retry {attempt + 1}/{init_retries}")

    retry_with_backoff(
        lambda: dist.init_process_group(backend, **kwargs),
        retries=init_retries,
        exceptions=(RuntimeError, OSError),
        backoff=Backoff(base=2.0, factor=2.0, max_delay=60.0, jitter=0.5),
        on_retry=note,
    )
    if multihost:
        # the obs stream and the CSV rows attribute by rank
        os.environ.setdefault("DDL_PROCESS_ID", str(dist.get_rank()))


def world_info(device=None) -> dict:
    """Rank, world and device of this process, under the JAX package's
    keys; ``device`` is the torch device the rank uses (default CUDA)."""
    device = torch.device("cuda" if device is None else device)
    joined = dist.is_initialized()
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        local = [f"cuda:{index} ({torch.cuda.get_device_name(index)})"]
        platform, count = "gpu", torch.cuda.device_count()
    else:
        local, platform, count = [str(device)], "cpu", 1
    info = {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "host_id": host_id(),
        "restart_epoch": restart_epoch(),
        "local_devices": local,
        "global_device_count": dist.get_world_size() if joined else count,
        "platform": platform,
    }
    if joined:
        info["backend"] = dist.get_backend()
    return info


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _end(procs) -> None:
    """Kill what is still running and reap it: a peer blocked in a
    collective with a dead rank would otherwise wait for the backend's
    timeout."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def spawn_local(cmd: list[str], world: int, env: dict | None = None,
                log_dir: str | os.PathLike | None = None,
                timeout_s: float | None = None) -> int:
    """Run ``cmd`` as ranks 0..world-1 of a one-host world and return the
    world's exit code.

    Each rank gets ``DDL_COORDINATOR`` (``localhost`` and a free port),
    ``DDL_NUM_PROCESSES``, ``DDL_PROCESS_ID`` and ``DDL_LOCAL_RANK`` on top
    of ``env`` (default: this process's environment); with ``log_dir`` its
    output goes to ``<log_dir>/rank<r>.log``.  SIGTERM and SIGINT sent to
    the spawner are passed on to every rank.  The first rank to exit
    non-zero decides: with ``EXIT_PREEMPTED`` the others get
    ``PREEMPT_GRACE_S`` to stop after the same step as it did, any other
    code ends them at once; either way the code is returned.  0 when
    every rank exits 0; with ``timeout_s``, a world still running then is
    ended and 124 returned (``timeout``'s code)."""
    from ddl_tpu_torch.supervisor import EXIT_PREEMPTED

    base = dict(os.environ if env is None else env)
    coordinator = f"localhost:{_free_port()}"
    files, procs = [], []
    for r in range(world):
        rank_env = dict(base, DDL_COORDINATOR=coordinator, DDL_NUM_PROCESSES=str(world),
                        DDL_PROCESS_ID=str(r), DDL_LOCAL_RANK=str(r))
        out = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"rank{r}.log"), "w")
            files.append(out)
        procs.append(subprocess.Popen(cmd, env=rank_env, stdout=out,
                                      stderr=subprocess.STDOUT if out else None))

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, forward)
    except ValueError:  # not the main thread: the ranks get signals directly
        pass
    stop = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        first, deadline = 0, None
        while True:
            codes = [p.poll() for p in procs]
            # the failure is read before the all-exited check: ranks that
            # all exit between two polls still return the first failure
            failed = [c for c in codes if c not in (None, 0)]
            if failed and not first:
                first = failed[0]
                if first != EXIT_PREEMPTED:
                    _end(procs)
                    return first
                deadline = time.monotonic() + PREEMPT_GRACE_S
            if all(c is not None for c in codes):
                return first
            if deadline is not None and time.monotonic() > deadline:
                _end(procs)
                return first
            if stop is not None and time.monotonic() > stop:
                _end(procs)
                return 124
            time.sleep(POLL_S)
    finally:
        _end(procs)
        for sig, prev in previous.items():
            signal.signal(sig, prev)
        for f in files:
            f.close()


def run_as_world(module: str, argv: list[str], world: int, device, cpu_devices: int) -> bool:
    """Run ``python -m <module> <argv>`` as the ``world`` ranks of a
    one-host world, the entry points' one rule for starting their ranks.

    False (nothing started; the caller runs as its rank) when the
    environment describes a world or ``world`` is 1.  Otherwise the
    devices are checked first (``check_local_world``: one CUDA device a
    rank, or on the CPU the ``cpu_devices`` of ``--cpu-devices N``), the
    ranks run to their end, and True is returned when the world exited 0;
    any other exit code is raised as ``SystemExit``."""
    if world <= 1 or in_world():
        return False
    check_local_world(world, device, cpu_devices)
    code = spawn_local([sys.executable, "-m", module, *argv], world)
    if code:
        raise SystemExit(code)
    return True
