"""Modeled pipeline-schedule accounting: F/B/W lanes and bubble math for
the port's two schedules (from ``ddl_tpu/obs/schedule_model.py``, pure
Python).

The pipeline's clock loop (``parallel/pipeline.py``) realises its
schedule as ticks in lockstep, so the *implementation* cannot show where
a schedule's bubble goes.  This module models the same schedules on
idealised hardware that skips empty slots: a dependency-respecting list
schedule over the unit tasks

    F(m, s)   forward of microbatch m on stage s
    B(m, s)   backward input-cotangent pass (activation gradient)
    W(m, s)   backward weight-gradient pass

with F(m, s) waiting on F(m, s-1), B(m, s) on F(m, s) and B(m, s+1),
and W(m, s) on B(m, s), each of one work unit.  GPipe and 1F1B run B
and W back-to-back (their full backward is one autograd call).

The pipelined Trainer emits a ``pipe_schedule`` obs event carrying the
per-stage phase/idle summary (``schedule_summary``), the JAX package's
event for the same schedule; its readers (``obs trace --step``, ``bench
digest``) are ROADMAP item 13.  The JAX package's interleaved and
zero-bubble schedules come with their pipelines (item 11).

Pure stdlib, like the rest of the obs read path.
"""

from __future__ import annotations

__all__ = ["SCHEDULES", "schedule_summary"]

SCHEDULES = ("gpipe", "1f1b")


def _sequences(schedule: str, P: int, M: int) -> list[list[tuple]]:
    """Per-stage task sequences ``[("F"|"B"|"W", m, s), ...]`` in the
    order each schedule's stage executes them."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    seqs = []
    for s in range(P):
        if schedule == "gpipe":
            seq = [("F", m, s) for m in range(M)]
            # autodiff replays the ticks backwards; the full backward of
            # a unit is B immediately followed by W
            for m in reversed(range(M)):
                seq += [("B", m, s), ("W", m, s)]
        else:
            w = min(P - s, M)
            seq = [("F", m, s) for m in range(w)]
            for k in range(M):
                seq += [("B", k, s), ("W", k, s)]
                if w + k < M:
                    seq.append(("F", w + k, s))
        seqs.append(seq)
    return seqs


def _lanes(schedule: str, P: int, M: int) -> list[list[dict]]:
    """Per-stage lanes ``[{"phase", "mb", "stage", "t0", "t1"}, ...]`` of
    the modeled schedule (times in work units from 0)."""
    if P < 1 or M < 1:
        raise ValueError("need n_stages/microbatches >= 1")
    seqs = _sequences(schedule, P, M)
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
                    deps = [("F", m, sig)] + ([("B", m, sig + 1)] if sig < P - 1 else [])
                else:
                    deps = [("B", m, sig)]
                if any(d not in done for d in deps):
                    break
                t0 = max([free[s]] + [done[d] for d in deps])
                done[(kind, m, sig)] = free[s] = t0 + 1.0
                lanes[s].append({"phase": kind, "mb": m, "stage": sig, "t0": t0, "t1": t0 + 1.0})
                ptr[s] += 1
                remaining -= 1
                progress = True
    if remaining:
        raise ValueError(f"schedule {schedule!r} deadlocked with {remaining} task(s) "
                         "unscheduled — sequencing bug")
    return lanes


def schedule_summary(schedule: str, n_stages: int, num_microbatches: int) -> dict:
    """Per-stage phase/idle accounting of the modeled schedule: the
    payload of the ``pipe_schedule`` obs event.  ``idle_units`` sums
    every stage's idle time over the schedule's makespan;
    ``bubble_fraction`` is its share of the pipeline's total stage-time
    ``n_stages * makespan``."""
    lanes = _lanes(schedule, int(n_stages), int(num_microbatches))
    makespan = max(u["t1"] for lane in lanes for u in lane)
    per_stage = []
    for lane in lanes:
        phases = {"F": 0.0, "B": 0.0, "W": 0.0}
        for u in lane:
            phases[u["phase"]] += u["t1"] - u["t0"]
        per_stage.append({**{k: round(v, 6) for k, v in phases.items()},
                          "idle": round(makespan - sum(phases.values()), 6)})
    idle = sum(st["idle"] for st in per_stage)
    return {
        "schedule": schedule,
        "pipe": int(n_stages),
        "microbatches": int(num_microbatches),
        "makespan": round(makespan, 6),
        "idle_units": round(idle, 6),
        "bubble_fraction": round(idle / (n_stages * makespan), 6),
        "per_stage": per_stage,
    }
