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

The backend is NCCL for a rank on a CUDA device and gloo on the CPU
(``DDL_DIST_BACKEND`` names another, e.g. gloo where several ranks share
one card), and the handshake is retried with the JAX package's backoff.
``spawn_local`` starts the ranks of a one-host world (the command line's
``dp``, ``pp`` and ``dp_pp`` presets do this when no world is set in the
environment): each gets the ``DDL_*`` variables of its rank, and the
spawner waits on all of them.  The spawner hosts the world's TCP store
itself (``DDL_STORE_HOSTED=1``: every rank joins it as a client), bound
before any rank starts and held until the world ends, so the address it
hands out is never one it has released.  The first rank to fail ends the
others and its exit code is the spawner's, so a dead rank never leaves
its peers blocked in a collective, and a preemption's ``EXIT_PREEMPTED``
reaches the supervisor, which relaunches the whole world.

Under pod supervision (``supervisor.supervise_pod_command``: the
``DDL_COORD_*`` variables set) the command line's process is one host's
launcher (``run_pod_host``).  It starts the host's ``L = world /
len(members)`` local ranks of ONE world spanning every live host: local
rank ``l`` of host ``h`` is global rank ``members.index(h) * L + l``.  The
leader host's launcher hosts the store and publishes its address for the
restart epoch through the rendezvous (``coordinator-e<E>``), so no host
ever joins the store of an earlier epoch; an operator-set
``DDL_COORDINATOR`` is used instead, as the JAX package uses it.
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
    "run_pod_host",
    "spawn_local",
    "world_info",
]

# How long the spawner lets the other ranks finish after one exits with
# EXIT_PREEMPTED (they stop after the same step and exit alike) before it
# ends them.
PREEMPT_GRACE_S = 120.0
# How often the spawner looks at its ranks.
POLL_S = 0.05
# The store a pod host's launcher hosts when it becomes its one rank.
_HOSTED: list = []


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
    have, what = _host_devices(world, device, cpu_devices)
    if world > have:
        raise ValueError(f"the mesh needs {world} devices, one a rank; this host has "
                         f"{have} {what}")


def _host_devices(world: int, device, cpu_devices: int) -> tuple[int, str]:
    """The devices this host offers a world of ``world`` ranks, and what
    they are."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return max(cpu_devices, 1), "CPU device(s) (--cpu-devices N)"
    if device.index is not None and world > 1:
        raise ValueError(f"a world of {world} ranks puts each on its own device; "
                         f"--device {device} names one (pass --device cuda)")
    if device.index is not None:
        return 1, "CUDA device(s)"
    return torch.cuda.device_count() if torch.cuda.is_available() else 0, "CUDA device(s)"


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
    With ``DDL_STORE_HOSTED=1`` the store at the coordinator's address is
    hosted by the launcher and rank 0 joins it as a client like the rest.
    ``device`` is this rank's device (default ``cuda:<local rank>``), which
    becomes the current CUDA device; ``backend`` defaults to
    ``DDL_DIST_BACKEND``, else NCCL for a CUDA device and gloo for the
    CPU, and is named only where several ranks share one card (NCCL
    refuses that).  A failed handshake
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
        kwargs = dict(world_size=num_processes, rank=process_id)
        if os.environ.get("DDL_STORE_HOSTED") == "1":
            host, _, port = coordinator_address.rpartition(":")
            kwargs["store"] = lambda: dist.TCPStore(host, int(port), num_processes,
                                                    is_master=False)
        else:
            kwargs["init_method"] = _init_method(coordinator_address)
    elif multihost:
        kwargs = dict(init_method="env://")
    else:
        return

    device = resolve_rank_device(device)
    backend = (backend or os.environ.get("DDL_DIST_BACKEND")
               or ("nccl" if device.type == "cuda" else "gloo"))
    if device.type == "cuda":
        torch.cuda.set_device(device)

    from ddl_tpu_torch.utils.backoff import Backoff, retry_with_backoff

    def note(e, attempt):
        print(f"[ddl_tpu_torch] init_process_group failed ({e}); "
              f"retry {attempt + 1}/{init_retries}")

    def join():
        # a hosted store's client is made anew on every attempt
        args = {k: v() if k == "store" else v for k, v in kwargs.items()}
        dist.init_process_group(backend, **args)

    retry_with_backoff(
        join,
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


def host_store(port: int = 0, world: int | None = None, host: str = "localhost"):
    """A TCP store server bound to ``port`` (0: one the system picks) for
    a world whose ranks join it as clients; returns ``(store, address)``.
    The caller holds ``store`` until the world ends: the port stays bound
    from before the first rank starts, so no other process can take it in
    between.  A port already in use raises at once (the bind error)."""
    from datetime import timedelta

    store = dist.TCPStore(host, port, world, is_master=True, wait_for_workers=False,
                          timeout=timedelta(seconds=300))
    return store, f"{host}:{store.port}"


def _die_with_parent():
    """A ``preexec_fn`` that makes a rank end with SIGKILL when its spawner
    dies (Linux's PR_SET_PDEATHSIG), so a launcher killed by its
    supervisor never leaves ranks behind; None where libc has no
    ``prctl``.  The function is looked up here, before the fork: the child
    only calls it."""
    import ctypes

    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return None
    return lambda: prctl(1, signal.SIGKILL)


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
                timeout_s: float | None = None, ranks: list[dict] | None = None) -> int:
    """Run ``cmd`` as ranks 0..world-1 of a one-host world and return the
    world's exit code.

    The spawner hosts the world's store (``host_store``, on a port the
    system picks) and each rank gets ``DDL_COORDINATOR`` (its
    ``localhost`` address), ``DDL_STORE_HOSTED=1``,
    ``DDL_NUM_PROCESSES``, ``DDL_PROCESS_ID`` and ``DDL_LOCAL_RANK`` on
    top of ``env`` (default: this process's environment); ``ranks``
    (one dict per local rank) replaces those rank variables, as a pod
    host's launcher does.  With ``log_dir`` a rank's output goes to
    ``<log_dir>/rank<r>.log``.  SIGTERM and SIGINT sent to the spawner are
    passed on to every rank, and a rank dies with its spawner.  The first
    rank to exit non-zero decides: with ``EXIT_PREEMPTED`` the others get
    ``PREEMPT_GRACE_S`` to stop after the same step as it did, any other
    code ends them at once; either way the code is returned.  0 when every
    rank exits 0; with ``timeout_s``, a world still running then is ended
    and 124 returned (``timeout``'s code)."""
    from ddl_tpu_torch.supervisor import EXIT_PREEMPTED

    base = dict(os.environ if env is None else env)
    store = None  # held, and its port bound, until the world ends
    if ranks is None:
        store, coordinator = host_store(0, world)
        ranks = [dict(DDL_COORDINATOR=coordinator, DDL_STORE_HOSTED="1",
                      DDL_NUM_PROCESSES=str(world), DDL_PROCESS_ID=str(r),
                      DDL_LOCAL_RANK=str(r)) for r in range(world)]
    files, procs, die_with_parent = [], [], _die_with_parent()
    for r, rank_vars in enumerate(ranks):
        out = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"rank{r}.log"), "w")
            files.append(out)
        procs.append(subprocess.Popen(cmd, env=dict(base, **rank_vars), stdout=out,
                                      stderr=subprocess.STDOUT if out else None,
                                      preexec_fn=die_with_parent))

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


def _pod_launcher() -> bool:
    """Whether this process is a pod host's launcher: pod supervision's
    environment (``DDL_COORD_DIR``) and no rank of its own yet."""
    return bool(os.environ.get("DDL_COORD_DIR")) and not os.environ.get("DDL_LOCAL_RANK")


def run_pod_host(module: str, argv: list[str], world: int, device, cpu_devices: int,
                 spec=None) -> bool:
    """One pod host's share of a world of ``world`` ranks (the config's
    ``mesh.num_devices``) spanning the live members
    (``coord.from_env``): ``L = world / len(members)`` local ranks, local
    rank ``l`` at global rank ``members.index(host) * L + l``.

    Everything is checked before any rank starts: ``world`` must divide
    over the members, the host's devices must hold its ``L`` ranks (after
    an elastic scale-down the survivors' devices may no longer hold the
    mesh ``spec``: refused in the JAX package's words, "mesh ... needs N
    devices, have M"), and every host's ``L`` must be the leader's
    (``ValueError`` otherwise).  The store's address comes from an
    operator-set ``DDL_COORDINATOR`` (rank 0 hosts it, as in the JAX
    package) or else from the leader, which hosts a fresh store for this
    restart epoch and publishes it as ``coordinator-e<E>``
    (``DDL_COORDINATOR_HOST`` names the address peers reach it at,
    default this host's name).  With ``L`` 1 this process becomes the rank
    (False: the caller runs on as it, as ``run_as_world`` returns);
    otherwise it runs the ranks to their end and returns True when the
    world exited 0, raising any other exit code as ``SystemExit``."""
    from ddl_tpu_torch import coord

    rv = coord.from_env()
    members, n = list(rv.members), len(rv.members)
    if world % n:
        raise ValueError(f"the mesh's {world} ranks do not divide over the pod's {n} live "
                         f"host(s) {members}")
    local = world // n
    have, what = _host_devices(local, device, cpu_devices)
    if local > have:
        raise ValueError(f"mesh {spec or world} needs {world} devices, have {n * have} "
                         f"({n} live host(s) {members} of {have} {what} each)")
    first = members.index(rv.host) * local
    operator = os.environ.get("DDL_COORDINATOR")
    store = None
    if operator:
        coordinator, hosted = operator, "0"
    else:
        want = {"world": world, "local": local, "hosts": members}

        def publish():
            nonlocal store
            store, address = host_store(0, world, os.environ.get("DDL_COORDINATOR_HOST")
                                        or socket.gethostname())
            return dict(want, coordinator=address)

        agreed = rv.agree(f"coordinator-e{restart_epoch()}", publish)
        if {k: agreed.get(k) for k in want} != want:
            raise ValueError(f"host {rv.host} would start {local} of {world} ranks over "
                             f"hosts {members}; the leader h{rv.leader} starts "
                             f"{agreed.get('local')} of {agreed.get('world')} over "
                             f"{agreed.get('hosts')}")
        coordinator, hosted = agreed["coordinator"], "1"
    ranks = [dict(DDL_COORDINATOR=coordinator, DDL_STORE_HOSTED=hosted,
                  DDL_NUM_PROCESSES=str(world), DDL_PROCESS_ID=str(first + r),
                  DDL_LOCAL_RANK=str(r)) for r in range(local)]
    print(f"[ddl_tpu_torch] pod host {rv.host} of members {members}: global ranks "
          f"{first}..{first + local - 1} of {world} at {coordinator} (restart epoch "
          f"{restart_epoch()})", flush=True)
    if local == 1:
        os.environ.update(ranks[0])
        # this process is the rank: the store it hosts lives as long as it
        _HOSTED.append(store)
        return False
    code = spawn_local([sys.executable, "-m", module, *argv], local, ranks=ranks)
    if code:
        raise SystemExit(code)
    return True


def run_as_world(module: str, argv: list[str], world: int, device, cpu_devices: int,
                 spec=None) -> bool:
    """Run ``python -m <module> <argv>`` as the ``world`` ranks of a
    one-host world, the entry points' one rule for starting their ranks.

    Under pod supervision this is a pod host's launcher
    (``run_pod_host``; ``spec``, the config's ``MeshSpec``, names the mesh
    in its refusal).  False (nothing started; the caller runs as its
    rank) when the environment describes a world or ``world`` is 1.
    Otherwise the
    devices are checked first (``check_local_world``: one CUDA device a
    rank, or on the CPU the ``cpu_devices`` of ``--cpu-devices N``), the
    ranks run to their end, and True is returned when the world exited 0;
    any other exit code is raised as ``SystemExit``."""
    if _pod_launcher():
        return run_pod_host(module, argv, world, device, cpu_devices, spec)
    if world <= 1 or in_world():
        return False
    check_local_world(world, device, cpu_devices)
    code = spawn_local([sys.executable, "-m", module, *argv], world)
    if code:
        raise SystemExit(code)
    return True
