"""Deterministic fault injection for proving recovery paths end-to-end
(port of ``ddl_tpu/utils/faultinject.py``: the host-side sites).

A fault-tolerance layer that has never seen a fault is decoration; this
harness lets tests (and operators, via the ``DDL_FAULT`` env var) inject
the exact failures the runtime claims to survive, at a deterministic
point, with no hardware involved:

    DDL_FAULT="preempt@step:12"        preemption signal at global step 12
    DDL_FAULT="crash@step:8"           raise InjectedCrash at step 8
    DDL_FAULT="nan@step:5"             poison the enclosing period's loss
    DDL_FAULT="spike@step:5"           multiply the enclosing period's loss
                                       by arg (default 1e3) — a FINITE
                                       divergence for the loss-spike detector
    DDL_FAULT="stall@step:4:30"        sleep 30s at step 4 (trips watchdog)
    DDL_FAULT="corrupt_ckpt@save:2"    corrupt the 2nd snapshot after commit
    DDL_FAULT="io@save:1:2"            OSError on save attempts 1 and 2
    DDL_FAULT="io@batch:5"             OSError on the 5th loader sample read

The JAX package's device-side kinds — ``nan@grad`` (a non-finite gradient
inside the compiled step) and ``leak@step`` (held device memory for the
HBM ledger) — and the pod drill ``rejoin@epoch`` are ROADMAP item 9:
activating any of them raises ``NotImplementedError`` instead of being
ignored.

Grammar: comma-separated ``kind@site:at[:arg]`` specs.  ``site`` is an
instrumentation point (``step`` in the training loops, ``save`` in
``checkpoint.py``, ``batch`` in ``data/loader.py``); ``at`` is the 0-based
coordinate for externally-counted sites (the global step) or the 1-based
call count for internally-counted ones (saves, batch reads); ``arg`` is
the stall duration in seconds for ``stall`` and the repeat count for
``io`` (default 1).

**The consume-on-fire rule.**  Each spec fires exactly ``repeat`` times
and then stays quiet; a fired spec models a one-off event (an eviction
does not recur).  When ``DDL_FAULT_STATE`` names a file, ``fire()``
appends the spec's canonical key there at the moment it exhausts —
*before* the fault acts, so a crash/exit cannot lose the record — and a
relauncher rebuilds ``DDL_FAULT`` with only the specs not consumed.
Tests that drive relaunch in-process use ``activate()``/``deactivate()``
to the same effect.

Every hook is a no-op (one ``is None`` check) when no injector is
active; production code pays nothing.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "InjectedCrash",
    "activate",
    "active",
    "check_step",
    "corrupt_check",
    "corrupt_snapshot",
    "deactivate",
    "io_check",
    "poison_loss",
]

KINDS = (
    "preempt", "crash", "nan", "spike", "stall", "corrupt_ckpt", "io",
    "rejoin", "leak",
)


def _not_ported(spec: "FaultSpec") -> bool:
    """The kinds the JAX package fires from device code (``nan@grad``,
    ``leak``) or from its pod drill (``rejoin``): ROADMAP item 9 here."""
    return spec.kind in ("leak", "rejoin") or (spec.kind, spec.site) == ("nan", "grad")


class InjectedCrash(RuntimeError):
    """The crash the harness raises for ``crash@...`` specs — a stand-in
    for any unhandled trainer exception a relaunch must survive."""


@dataclass
class FaultSpec:
    kind: str
    site: str
    at: int
    arg: float | None = None
    fired: int = 0

    @property
    def repeat(self) -> int:
        return int(self.arg) if self.kind == "io" and self.arg else 1

    @property
    def key(self) -> str:
        """Canonical spec text — the identity the consume-on-fire state
        file records and a relaunch filter matches on."""
        base = f"{self.kind}@{self.site}:{self.at}"
        return base if self.arg is None else f"{base}:{self.arg:g}"

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """``kind@site:at[:arg]`` -> FaultSpec, with loud errors."""
        try:
            kind, _, rest = text.strip().partition("@")
            site, _, coord = rest.partition(":")
            at, _, arg = coord.partition(":")
            spec = cls(
                kind=kind.strip(),
                site=site.strip(),
                at=int(at),
                arg=float(arg) if arg else None,
            )
        except ValueError as e:
            raise ValueError(
                f"bad fault spec {text!r} (want kind@site:at[:arg], e.g. "
                f"preempt@step:12 or io@save:1:2): {e}"
            ) from None
        if spec.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {spec.kind!r} in {text!r} "
                f"(known: {', '.join(KINDS)})"
            )
        if not spec.site:
            raise ValueError(f"empty fault site in {text!r}")
        if _not_ported(spec):
            raise NotImplementedError(
                f"fault {text.strip()!r} is not ported yet (ROADMAP item 9: the "
                "device-side fault sites and the pod drill)"
            )
        return spec


class FaultInjector:
    """Holds the parsed specs plus per-site call counters; ``fire()`` is
    the single matching primitive every hook goes through."""

    def __init__(self, specs: list[FaultSpec]) -> None:
        self.specs = specs
        self.counts: dict[str, int] = {}
        self.nan_pending = False
        self.spike_scale = None  # pending finite loss-spike multiplier
        self.log: list[tuple[str, str, int]] = []  # (kind, site, coord)

    @classmethod
    def parse(cls, text: str) -> "FaultInjector":
        return cls(
            [FaultSpec.parse(p) for p in text.split(",") if p.strip()]
        )

    def fire(
        self,
        site: str,
        at: int | None = None,
        kinds: tuple[str, ...] | None = None,
    ) -> list[FaultSpec]:
        """Faults due at this visit of ``site``, restricted to ``kinds``.
        With ``at`` the site is externally indexed (fires once the
        coordinate reaches ``spec.at``); without it an internal 1-based
        call counter is used, keyed per (site, kinds) so hooks that share
        a site name (save-attempt vs save-commit) count independently."""
        if at is None:
            key = f"{site}|{','.join(kinds) if kinds else '*'}"
            self.counts[key] = at = self.counts.get(key, 0) + 1
        due = []
        for s in self.specs:
            if (
                s.site == site
                and (kinds is None or s.kind in kinds)
                and s.fired < s.repeat
                and at >= s.at
            ):
                s.fired += 1
                self.log.append((s.kind, site, at))
                if s.fired >= s.repeat:
                    _record_consumed(s)
                due.append(s)
        return due


def _record_consumed(spec: FaultSpec) -> None:
    """Append an exhausted spec's key to the DDL_FAULT_STATE file (set by
    a relauncher) so the relaunch env drops exactly the specs that
    fired.  Called BEFORE the fault acts — a crash/exit cannot lose the
    record.  Best-effort: state-file I/O failing must not turn a test
    fault into a different fault."""
    path = os.environ.get("DDL_FAULT_STATE")
    if not path:
        return
    try:
        with open(path, "a") as fh:
            fh.write(spec.key + "\n")
            fh.flush()
    except OSError:
        pass


# --------------------------------------------------------------------------
# module-level activation: lazily from DDL_FAULT, or explicitly by tests
# --------------------------------------------------------------------------

_injector: FaultInjector | None = None
_env_checked = False


def activate(spec: str) -> FaultInjector:
    global _injector, _env_checked
    _injector = FaultInjector.parse(spec)
    _env_checked = True
    return _injector


def deactivate() -> None:
    global _injector, _env_checked
    _injector = None
    # re-arm the env check so a fresh DDL_FAULT is picked up next time
    _env_checked = False


def active() -> FaultInjector | None:
    global _injector, _env_checked
    if not _env_checked:
        _env_checked = True
        env = os.environ.get("DDL_FAULT")
        if env:
            _injector = FaultInjector.parse(env)
    return _injector


# --------------------------------------------------------------------------
# instrumentation hooks (each a no-op when nothing is active)
# --------------------------------------------------------------------------


def check_step(step: int, guard=None) -> None:
    """Per-training-step hook.  Handles the step-site faults: ``preempt``
    requests the preemption guard (snapshot + clean resumable exit),
    ``crash`` raises, ``stall`` sleeps past the watchdog deadline, ``nan``
    marks the period's loss for poisoning, ``spike`` scales it."""
    inj = active()
    if inj is None:
        return
    for f in inj.fire(
        "step", at=step, kinds=("preempt", "crash", "stall", "nan", "spike"),
    ):
        if f.kind == "preempt":
            if guard is not None:
                guard.request()
        elif f.kind == "crash":
            raise InjectedCrash(f"injected crash at step {step}")
        elif f.kind == "stall":
            time.sleep(f.arg if f.arg else 30.0)
        elif f.kind == "nan":
            inj.nan_pending = True
        elif f.kind == "spike":
            inj.spike_scale = f.arg if f.arg else 1e3


def poison_loss(metrics: dict) -> dict:
    """Period-end hook (``train/loop.py``): if a ``nan`` fault fired this
    period, replace the loss with NaN so the recovery policy sees exactly
    what a diverged step produces; a ``spike`` fault instead multiplies
    it by the spec's arg — a finite excursion for the loss-spike
    detector's trigger path."""
    inj = active()
    if inj is not None and inj.nan_pending:
        inj.nan_pending = False
        metrics = dict(metrics)
        metrics["loss"] = float("nan")
    elif inj is not None and inj.spike_scale is not None:
        scale, inj.spike_scale = inj.spike_scale, None
        metrics = dict(metrics)
        if metrics.get("loss") is not None:
            metrics["loss"] = float(metrics["loss"]) * scale
    return metrics


def io_check(site: str) -> None:
    """Raise an injected OSError for ``io@<site>`` specs — placed at the
    top of retryable I/O operations (snapshot save attempts, loader
    sample reads)."""
    inj = active()
    if inj is None:
        return
    if inj.fire(site, kinds=("io",)):
        raise OSError(f"injected I/O error at {site}")


def corrupt_check(path) -> None:
    """Post-commit hook (``checkpoint.py``): for ``corrupt_ckpt@save``
    specs, truncate the largest data file of the just-committed snapshot
    — the shape of a torn shared-NAS write — so integrity verification
    must catch it."""
    inj = active()
    if inj is None:
        return
    if inj.fire("save", kinds=("corrupt_ckpt",)):
        corrupt_snapshot(path)


def corrupt_snapshot(path) -> None:
    """Truncate the largest non-manifest file under ``path`` in place."""
    from pathlib import Path

    files = [
        p for p in Path(path).rglob("*")
        if p.is_file() and p.name != "ddl_manifest.json"
    ]
    if not files:
        raise FileNotFoundError(f"nothing to corrupt under {path}")
    victim = max(files, key=lambda p: p.stat().st_size)
    size = victim.stat().st_size
    with open(victim, "r+b") as fh:
        fh.truncate(size // 2)
