"""Modeled pipeline-schedule accounting: F/B/W lanes and bubble math
(from ``ddl_tpu/obs/schedule_model.py``, pure Python).

The pipelines' clock loops (``parallel/pipeline.py``, ``parallel/
lm_pipeline.py``) realise their schedules as ticks in lockstep, so the
*implementation* cannot show where a schedule's bubble goes.  This module
models the same schedules on idealised hardware that skips empty slots:
a dependency-respecting list schedule over the unit tasks

    F(m, sigma)   forward of microbatch m on global stage sigma
    B(m, sigma)   backward input-cotangent pass (activation gradient)
    W(m, sigma)   backward weight-gradient pass

with F(m, sigma) waiting on F(m, sigma-1), B(m, sigma) on F(m, sigma)
and B(m, sigma+1), and W(m, sigma) on B(m, sigma).  GPipe and 1F1B run B
and W back-to-back (their full backward is one autograd call); the
zero-bubble schedule defers each stage's W into the queue the clock loop
carries (capacity ``s``) and drains it where the stage would otherwise
idle.  Unit costs default to t_F = t_B = t_W = 1 and scale by 1/V under
virtual stages so every schedule does the same total work.

The pipelined trainers emit a ``pipe_schedule`` obs event carrying the
per-stage phase/idle summary (``schedule_summary``), the JAX package's
event for the same schedule; its readers (``obs trace --step``, ``bench
digest`` and its ``schedule_table``) are ROADMAP item 13.

Pure stdlib, like the rest of the obs read path.
"""

from __future__ import annotations

__all__ = ["SCHEDULES", "schedule_lanes", "schedule_summary"]

# "interleaved" is the virtual-stage GPipe schedule (the clock loop
# selects it via virtual_stages > 1)
SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb")


def _sequences(schedule: str, P: int, M: int, V: int):
    """Per-device task sequences ``[("F"|"B"|"W", m, sigma), ...]`` in
    the order each schedule's device executes them."""
    seqs = []
    for s in range(P):
        if schedule == "gpipe":
            if V == 1:
                fwd = [(m, s) for m in range(M)]
            else:
                # Megatron virtual-stage placement: global stage
                # sigma = c*P + s on device s, microbatches in groups
                # of P (matches make_blocks_pipeline_interleaved)
                fwd = [
                    (g * P + r, c * P + s)
                    for g in range(M // P)
                    for c in range(V)
                    for r in range(P)
                ]
            seq = [("F", m, sig) for m, sig in fwd]
            # autodiff replays the ticks backwards; the full backward of
            # a unit is B immediately followed by W
            for m, sig in reversed(fwd):
                seq.append(("B", m, sig))
                seq.append(("W", m, sig))
        elif schedule == "1f1b":
            w = min(P - s, M)
            seq = [("F", m, s) for m in range(w)]
            for k in range(M):
                seq.append(("B", k, s))
                seq.append(("W", k, s))
                if w + k < M:
                    seq.append(("F", w + k, s))
        elif schedule == "zb":
            # B on the critical path; W deferred into the per-stage
            # queue (capacity s = the stage's tail-idle tick count in
            # the clock loop) and drained oldest-first when over
            # capacity or when the B schedule has gone quiet
            w = min(P - s, M)
            cap = s
            seq = [("F", m, s) for m in range(w)]
            pending = drained = 0
            for k in range(M):
                seq.append(("B", k, s))
                pending += 1
                if pending > cap:
                    seq.append(("W", drained, s))
                    drained += 1
                    pending -= 1
                if w + k < M:
                    seq.append(("F", w + k, s))
            while drained < M:
                seq.append(("W", drained, s))
                drained += 1
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
        seqs.append(seq)
    return seqs


def schedule_lanes(
    schedule: str,
    n_stages: int,
    num_microbatches: int,
    virtual: int = 1,
    t_f: float = 1.0,
    t_b: float = 1.0,
    t_w: float = 1.0,
) -> list[list[dict]]:
    """Per-device lanes ``[{"phase", "mb", "stage", "t0", "t1"}, ...]``
    of the modeled schedule (times in work units from 0).

    ``schedule`` is one of ``SCHEDULES``; ``"interleaved"`` is
    ``"gpipe"`` with ``virtual`` (>= 2) chunks per device, and plain
    ``"gpipe"`` with ``virtual > 1`` means the same thing.  1F1B/zb are
    modeled single-chunk (the clock loops' supported combinations)."""
    P, M, V = int(n_stages), int(num_microbatches), int(virtual)
    if schedule == "interleaved":
        schedule, V = "gpipe", max(V, 2)
    if schedule not in ("gpipe", "1f1b", "zb"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if P < 1 or M < 1 or V < 1:
        raise ValueError("need n_stages/microbatches/virtual >= 1")
    if V > 1 and schedule != "gpipe":
        raise ValueError(
            f"virtual stages are modeled for the gpipe/interleaved "
            f"schedule only, not {schedule!r}"
        )
    if V > 1 and M % P:
        raise ValueError(
            f"microbatches {M} % pipe {P} != 0 (interleaved schedules "
            "advance microbatches in groups of pipe)"
        )
    dur = {"F": t_f / V, "B": t_b / V, "W": t_w / V}
    S = P * V
    seqs = _sequences(schedule, P, M, V)
    done: dict[tuple, float] = {}
    ptr = [0] * P
    free = [0.0] * P
    lanes: list[list[dict]] = [[] for _ in range(P)]
    remaining = sum(len(q) for q in seqs)
    progress = True
    while remaining and progress:
        progress = False
        for s in range(P):
            while ptr[s] < len(seqs[s]):
                kind, m, sig = seqs[s][ptr[s]]
                if kind == "F":
                    deps = [("F", m, sig - 1)] if sig else []
                elif kind == "B":
                    deps = [("F", m, sig)]
                    if sig < S - 1:
                        deps.append(("B", m, sig + 1))
                else:
                    deps = [("B", m, sig)]
                if any(d not in done for d in deps):
                    break
                t0 = max([free[s]] + [done[d] for d in deps])
                t1 = t0 + dur[kind]
                done[(kind, m, sig)] = t1
                lanes[s].append({
                    "phase": kind, "mb": m, "stage": sig,
                    "t0": t0, "t1": t1,
                })
                free[s] = t1
                ptr[s] += 1
                remaining -= 1
                progress = True
    if remaining:
        raise ValueError(
            f"schedule {schedule!r} deadlocked with {remaining} task(s) "
            "unscheduled — sequencing bug"
        )
    return lanes


def schedule_summary(
    schedule: str,
    n_stages: int,
    num_microbatches: int,
    virtual: int = 1,
    t_f: float = 1.0,
    t_b: float = 1.0,
    t_w: float = 1.0,
) -> dict:
    """Per-stage phase/idle accounting of the modeled schedule: the
    payload of the ``pipe_schedule`` obs event and one ``bench digest``
    table row.  ``idle_units`` sums every stage's idle time over the
    schedule's makespan; ``bubble_fraction`` is its share of the
    pipeline's total stage-time ``n_stages * makespan``."""
    # mirror schedule_lanes' normalization so the recorded metadata
    # matches the V the numbers were actually modeled at ("interleaved"
    # implies at least two chunks)
    if schedule == "interleaved":
        virtual = max(int(virtual), 2)
    lanes = schedule_lanes(
        schedule, n_stages, num_microbatches, virtual, t_f, t_b, t_w
    )
    makespan = max(u["t1"] for lane in lanes for u in lane)
    per_stage = []
    for lane in lanes:
        phases = {"F": 0.0, "B": 0.0, "W": 0.0}
        for u in lane:
            phases[u["phase"]] += u["t1"] - u["t0"]
        busy = sum(phases.values())
        per_stage.append({
            **{k: round(v, 6) for k, v in phases.items()},
            "idle": round(makespan - busy, 6),
        })
    idle = sum(st["idle"] for st in per_stage)
    return {
        "schedule": schedule,
        "pipe": int(n_stages),
        "microbatches": int(num_microbatches),
        "virtual": int(virtual),
        "makespan": round(makespan, 6),
        "idle_units": round(idle, 6),
        "bubble_fraction": round(idle / (n_stages * makespan), 6),
        "per_stage": per_stage,
    }
