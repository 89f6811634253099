"""Cluster smoke test (reference ``test.py``; counterpart of
``ddl_tpu/tools/smoke.py``): bring up the world, print each rank's
layout, and run one collective over each mesh axis against its closed
form.

Rank r = d * pipe + p of a ``(data, pipe)`` mesh holds the float ``r``;
summed over the ``data`` axis (``Mesh.group``) it must hold the sum of
e * pipe + p over the data rows e, and over the ``pipe`` axis
(``Mesh.pipe_group``) the sum of d * pipe + q over the stages q.

    python -m ddl_tpu_torch.tools.smoke --data 3 --pipe 2 [--cpu-devices 6]

starts the ranks itself (``launch.run_as_world``: one CUDA device a rank,
or gloo ranks on the ``--cpu-devices N`` CPU devices) unless the
environment describes a world, and exits nonzero if any rank's sums are
wrong.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from ddl_tpu_torch import launch
from ddl_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS, MeshSpec, build_mesh


def run_smoke(data: int, pipe: int = 1, device=None) -> bool:
    mesh = build_mesh(MeshSpec(data, pipe), device)
    print(f"[smoke] world: {launch.world_info(mesh.device)}", flush=True)
    print(f"[smoke] mesh: {mesh}", flush=True)
    d, p = mesh.data_index, mesh.pipe_index
    value = torch.full((1,), float(mesh.rank), device=mesh.device)
    got = {}
    for axis, group in ((DATA_AXIS, mesh.group), (PIPE_AXIS, mesh.pipe_group)):
        total = value.clone()
        if group is not None:
            dist.all_reduce(total, group=group)
        got[axis] = total.item()
    want = {DATA_AXIS: float(sum(e * pipe + p for e in range(data))),
            PIPE_AXIS: float(sum(d * pipe + q for q in range(pipe)))}
    ok = got == want
    print(f"[smoke] rank {mesh.rank}: sums over '{DATA_AXIS}' and '{PIPE_AXIS}' {got} "
          f"(closed form {want}): {'OK' if ok else 'FAIL'}", flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--pipe", type=int, default=1)
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="N CPU devices: gloo ranks on the CPU (default: one GPU a rank)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu_devices else None
    if launch.run_as_world("ddl_tpu_torch.tools.smoke", sys.argv[1:] if argv is None else argv,
                           args.data * args.pipe, device, args.cpu_devices):
        return
    launch.bootstrap(device)
    ok = run_smoke(args.data, args.pipe, device)
    if dist.is_initialized():
        # no rank tears its process group down while a peer is still in a
        # collective: exiting with it live let a rank abort in teardown
        # ("terminate called without an active exception")
        dist.barrier()
        dist.destroy_process_group()
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
