"""Collective-communication microbenchmarks over the ranks of a world
(counterpart of ``ddl_tpu/bench/comm.py``).

The reference's latency probe (``communication_time.py``): rank 0 times a
4 MiB fp32 ``send`` to rank 1 plus a 1-float ack ``recv``, 1000
iterations appended to a CSV of ``job_id,iteration,elapsed_ms`` rows,
iteration 0 being the set-up cost (NCCL builds the pair's communicator on
the first send).  On a card the round trip is timed with CUDA events on
rank 0's stream; on the CPU (gloo) with the host clock, where every call
has finished when it returns.  On top of the reference's ping-pong, the
collectives the trainer uses, ``all_reduce`` (the JAX package's ``psum``:
DDP's gradient buckets, the BatchNorm sums) and ``all_gather``, are timed
over a sweep of payloads, each with the JAX package's algorithmic
bandwidth: bytes moved per rank over the time, with 2 (n-1)/n of the
payload for an all-reduce and (n-1)/n of the gathered result for an
all-gather.

    python -m ddl_tpu_torch.bench.comm [--ranks 4] [--cpu-devices 4]

starts the ranks itself (``launch.run_as_world``: one CUDA device a rank,
or gloo ranks on the ``--cpu-devices N`` CPU devices) unless the
environment describes a world; rank 0 prints the summary as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass
from time import perf_counter

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "COLLECTIVE_OPS",
    "PingPongResult",
    "bandwidth_sweep",
    "collective_bandwidth",
    "ping_pong",
    "run_comm_bench",
]

COLLECTIVE_OPS = ("all_reduce", "all_gather")
DEFAULT_PAYLOAD_ELEMS = 1024 * 1024  # 4 MiB fp32, reference communication_time.py:18
# 64 KiB .. 64 MiB of fp32 per rank
SWEEP_ELEMS = tuple(1 << k for k in range(14, 25, 2))


@dataclass
class PingPongResult:
    times_ms: np.ndarray  # per-iteration round trip; iteration 0 is the set-up
    payload_bytes: int

    @property
    def mean_ms(self) -> float:
        """Mean round trip without iteration 0 (the set-up cost, as the
        reference's analysis drops it)."""
        if len(self.times_ms) <= 1:
            return float("nan")
        return float(self.times_ms[1:].mean())

    @property
    def one_way_gbps(self) -> float:
        return self.payload_bytes / (self.mean_ms * 1e-3) / 1e9


class _Clock:
    """Elapsed ms of the work between ``start`` and ``stop``: CUDA events
    on a card, the host clock on the CPU."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return perf_counter()

    def stop(self, begin) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return begin.elapsed_time(end)
        return (perf_counter() - begin) * 1e3


def _device() -> torch.device:
    """The rank's device: the current CUDA device under NCCL, the CPU
    under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("the comm bench runs inside a world (launch.bootstrap)")
    return torch.device("cuda", torch.cuda.current_device()) if (
        dist.get_backend() == "nccl") else torch.device("cpu")


def ping_pong(iterations: int = 1000,
              payload_elems: int = DEFAULT_PAYLOAD_ELEMS) -> PingPongResult:
    """Rank 0 sends ``payload_elems`` fp32 to rank 1 and receives a
    1-float ack, ``iterations + 1`` times; the other ranks wait.  Every
    rank returns rank 0's times."""
    device = _device()
    rank = dist.get_rank()
    x = torch.ones(payload_elems, dtype=torch.float32, device=device)
    times = torch.zeros(iterations + 1, dtype=torch.float64)
    clock = _Clock(device)
    for i in range(iterations + 1):
        if rank == 0:
            t0 = clock.start()
            dist.send(x, 1)
            dist.recv(x[:1], 1)
            times[i] = clock.stop(t0)
        elif rank == 1:
            dist.recv(x, 0)
            dist.send(x[:1], 0)
    dist.broadcast(times, 0, group=dist.new_group(backend="gloo"))
    return PingPongResult(times_ms=times.numpy(), payload_bytes=payload_elems * 4)


def collective_bandwidth(op: str, payload_elems: int = DEFAULT_PAYLOAD_ELEMS,
                         iterations: int = 50) -> dict:
    """Mean time and algorithmic bandwidth of ``op`` over every rank, with
    ``payload_elems`` fp32 per rank: one call to warm up, then
    ``iterations`` timed back to back."""
    device = _device()
    n = dist.get_world_size()
    x = torch.zeros(payload_elems, dtype=torch.float32, device=device)
    payload_bytes = payload_elems * 4
    if op == "all_reduce":
        def call():
            dist.all_reduce(x)
        moved = 2 * (n - 1) / n * payload_bytes
    elif op == "all_gather":
        out = torch.empty(n * payload_elems, dtype=torch.float32, device=device)

        def call():
            dist.all_gather_into_tensor(out, x)
        moved = (n - 1) / n * payload_bytes * n
    else:
        raise ValueError(f"unknown collective {op!r} (known: {', '.join(COLLECTIVE_OPS)})")
    call()
    dist.barrier()
    clock = _Clock(device)
    t0 = clock.start()
    for _ in range(iterations):
        call()
    ms = clock.stop(t0) / iterations
    return {"op": op, "devices": n, "payload_bytes": payload_bytes, "mean_ms": ms,
            "algbw_gbps": moved / (ms * 1e-3) / 1e9}


def bandwidth_sweep(ops=COLLECTIVE_OPS, sizes=SWEEP_ELEMS, iterations: int = 50) -> list[dict]:
    """``collective_bandwidth`` of every op at every payload."""
    return [collective_bandwidth(op, elems, iterations) for op in ops for elems in sizes]


def run_comm_bench(log_dir: str | os.PathLike = "training_logs", job_id: str | None = None,
                   iterations: int = 1000, payload_elems: int = DEFAULT_PAYLOAD_ELEMS,
                   sweep=SWEEP_ELEMS, sweep_iterations: int = 50) -> dict:
    """The ping-pong (its rows appended to ``<log_dir>/communication_time.
    csv`` by rank 0) and the collectives at ``payload_elems`` and over
    ``sweep``; returns the summary on every rank."""
    from ddl_tpu_torch.train.trainer import resolve_job_id

    job_id = job_id or resolve_job_id()
    n = dist.get_world_size()
    summary: dict = {"job_id": job_id, "devices": n, "backend": dist.get_backend()}
    if n < 2:
        return summary
    pp = ping_pong(iterations, payload_elems)
    if dist.get_rank() == 0:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "communication_time.csv"), "a") as f:
            for i, t in enumerate(pp.times_ms):
                f.write(f"{job_id},{i},{t}\n")
    summary["ping_pong_setup_ms"] = float(pp.times_ms[0])
    summary["ping_pong_mean_ms"] = pp.mean_ms
    summary["ping_pong_one_way_gbps"] = pp.one_way_gbps
    for op in COLLECTIVE_OPS:
        r = collective_bandwidth(op, payload_elems)
        summary[f"{op}_gbps"] = r["algbw_gbps"]
        summary[f"{op}_ms"] = r["mean_ms"]
    summary["sweep"] = bandwidth_sweep(sizes=sweep, iterations=sweep_iterations)
    return summary


def main(argv=None) -> dict | None:
    from ddl_tpu_torch import launch

    ap = argparse.ArgumentParser(description="ping-pong and collective bandwidth")
    ap.add_argument("--ranks", type=int, default=2,
                    help="ranks to start (one device each; at least 2)")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="N CPU devices: gloo ranks on the CPU (default: one GPU a rank)")
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--payload-elems", type=int, default=DEFAULT_PAYLOAD_ELEMS)
    ap.add_argument("--sweep-iterations", type=int, default=50)
    ap.add_argument("--log-dir", default=os.environ.get("DDL_LOG_DIR", "training_logs"))
    args = ap.parse_args(argv)
    if args.ranks < 2:
        ap.error("the ping-pong needs two ranks")
    device = "cpu" if args.cpu_devices else None
    if launch.run_as_world("ddl_tpu_torch.bench.comm", sys.argv[1:] if argv is None else argv,
                           args.ranks, device, args.cpu_devices):
        return None
    launch.bootstrap(device)
    summary = run_comm_bench(args.log_dir, iterations=args.iterations,
                             payload_elems=args.payload_elems,
                             sweep_iterations=args.sweep_iterations)
    if dist.get_rank() == 0:
        print(json.dumps(summary, indent=2))
    dist.destroy_process_group()
    return summary


if __name__ == "__main__":
    main()
