"""HBM ledger, the emit half (counterpart of ``ddl_tpu/obs/hbm.py:1-345``):
per-device memory accounting events under the JAX package's names.

``hbm_sample``
    A live breakdown: this rank's bytes for each tracked category
    (params, optimizer state, the serving KV pool split into cached,
    private and free blocks) beside the live watermark
    (``utils/memory.hbm_stats``: the CUDA caching allocator's bytes in
    use, its peak and the card's memory).  Off a card the watermark is
    synthesized as the tracked sum plus any injected leak
    (``synthetic: true``), as the JAX package does on a backend without
    memory stats, so the account and the leak drill work on the CPU too.

``hbm_plan``
    A per-program budget.  Torch compiles no executable with a memory
    analysis, so the program's first dispatch is the measurement
    (``plan_program`` runs it): ``aval`` mode counts argument and output
    bytes from the tensors' shapes; ``full`` mode on a card also takes the
    allocator's peak over that dispatch less the bytes in use before it
    as ``temp_bytes`` (``analysis: "allocator_peak"``).  ``alias_bytes``
    are the state the program reads and updates in place (the JAX
    package's donated buffers).  A field the port cannot know
    (``code_bytes``: there is no per-program executable) is null.

``hbm_oom_dump``
    The snapshot an allocation failure writes before the process dies:
    the failure text, the watermark, the resident tensors Python holds
    grouped by (shape, dtype), the tracked category bytes, and the plans
    this process emitted.

The read half (``account_from_fold``, ``render_hbm``, the fold's cell)
reads through ``obs/fold.py`` and is ROADMAP item 13.  Like the rest of
the ``obs`` package this module imports no torch at import time.
"""

from __future__ import annotations

import sys

__all__ = [
    "SAMPLE_FIELDS",
    "dump_oom",
    "is_oom_error",
    "live_sample",
    "plan_program",
    "sample_categories",
    "tree_shard_bytes",
]

# tracked category -> the hbm_sample event field carrying its bytes
SAMPLE_FIELDS = {
    "params": "params_bytes",
    "optimizer": "opt_bytes",
    "kv_cached": "kv_cached_bytes",
    "kv_private": "kv_private_bytes",
    "kv_free": "kv_free_bytes",
}

# static-plan byte fields carried by hbm_plan events
PLAN_FIELDS = (
    "analysis",
    "argument_bytes",
    "output_bytes",
    "temp_bytes",
    "alias_bytes",
    "code_bytes",
)

# tensor groups retained in an OOM dump / plans retained per process
MAX_OOM_BUFFERS = 24
MAX_PLANS = 64

# last-wins plan per label emitted by THIS process: what dump_oom attaches
_recent_plans: dict[str, dict] = {}


def sample_categories(e: dict) -> dict:
    """Tracked category bytes present on one ``hbm_sample`` event."""
    out = {}
    for cat, field in SAMPLE_FIELDS.items():
        v = e.get(field)
        if v is not None:
            out[cat] = int(v)
    return out


def _tensors(tree, seen: set):
    """Every tensor of ``tree`` (tensors, mappings, sequences, modules,
    generators of them), each once."""
    torch = sys.modules.get("torch")
    if tree is None or torch is None:
        return
    if isinstance(tree, torch.Tensor):
        if id(tree) not in seen:
            seen.add(id(tree))
            yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from _tensors(list(tree.parameters()), seen)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v, seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v, seen)
    elif hasattr(tree, "__next__"):  # a generator, e.g. model.parameters()
        for v in tree:
            yield from _tensors(v, seen)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tree_shard_bytes(tree) -> int | None:
    """This rank's bytes of the tensors of ``tree`` (each counted once):
    the port's ranks hold whole tensors, so a ZeRO shard counts as the
    shard it is.  None for a tree with no tensor."""
    tensors = list(_tensors(tree, set()))
    return _bytes(tensors) if tensors else None


def live_sample(
    writer,
    *,
    params_bytes: int | None = None,
    opt_bytes: int | None = None,
    kv_cached_bytes: int | None = None,
    kv_private_bytes: int | None = None,
    kv_free_bytes: int | None = None,
    step: int | None = None,
    context: str | None = None,
    device=None,
) -> dict | None:
    """Emit one ``hbm_sample``: the caller's tracked category bytes plus
    the watermark of ``device`` (default the current CUDA device).  Off a
    card the watermark is synthetic: the tracked sum plus the injected
    leak."""
    if writer is None:
        return None
    from ddl_tpu_torch.utils import faultinject
    from ddl_tpu_torch.utils.memory import hbm_stats

    tracked = sum(
        v for v in (
            params_bytes, opt_bytes, kv_cached_bytes,
            kv_private_bytes, kv_free_bytes,
        ) if v
    )
    leaked = faultinject.leaked_bytes()
    mem = hbm_stats(device)
    if mem is not None:
        watermark = mem["bytes_in_use"]
        peak = mem["peak_bytes_in_use"]
        limit = mem["bytes_limit"] or None
        synthetic = False
    else:
        watermark = peak = tracked + leaked
        limit = None
        synthetic = True
    return writer.emit(
        "hbm_sample",
        step=step,
        watermark=int(watermark),
        peak=int(peak),
        limit=limit,
        synthetic=synthetic,
        params_bytes=params_bytes,
        opt_bytes=opt_bytes,
        kv_cached_bytes=kv_cached_bytes,
        kv_private_bytes=kv_private_bytes,
        kv_free_bytes=kv_free_bytes,
        **({"context": context} if context else {}),
    )


def plan_mode() -> str:
    """``DDL_HBM_PLAN`` as the JAX package reads it: ``"off"`` (also 0 or
    false), ``"aval"``, else ``"full"``."""
    import os

    mode = os.environ.get("DDL_HBM_PLAN", "").strip().lower()
    if mode in ("0", "off", "false"):
        return "off"
    return "aval" if mode == "aval" else "full"


def plan_program(
    writer, label: str, fn, args=(), kwargs=None,
    step: int | None = None, mode: str = "full", resident=None, device=None,
):
    """Run ``fn(*args, **kwargs)`` once, the program's first dispatch, and
    emit one ``hbm_plan`` for it; returns ``(fn's output, the event)``.

    ``argument_bytes`` are the tensors of ``args``/``kwargs`` plus
    ``resident`` (the state the program reads and updates in place, such
    as a model's parameters and its optimizer's moments, which are also
    ``alias_bytes``), ``output_bytes`` those of the output.  ``mode="full"``
    on a CUDA ``device`` synchronises around the dispatch and records the
    allocator's peak over it less the bytes in use before it as
    ``temp_bytes`` (this resets the allocator's peak counter); otherwise,
    and in ``mode="aval"``, ``temp_bytes`` is null.  The budget never
    takes the run down: a measurement that fails leaves its fields null,
    and an error of ``fn`` itself propagates unchanged."""
    kwargs = kwargs or {}
    torch = sys.modules.get("torch")
    analysis = "aval"
    arg_b = out_b = temp_b = alias_b = None
    full = False
    try:
        seen: set = set()
        arg_b = _bytes(_tensors((args, kwargs), seen))
        if resident is not None:
            alias_b = tree_shard_bytes(resident) or 0
            arg_b += _bytes(_tensors(resident, seen))  # those not among args
        full = (mode == "full" and torch is not None and device is not None
                and torch.device(device).type == "cuda" and torch.cuda.is_available())
        if full:
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
    except Exception:
        full = False
    out = fn(*args, **kwargs)
    try:
        out_b = tree_shard_bytes(out) or 0
        if full:
            torch.cuda.synchronize(device)
            temp_b = int(torch.cuda.max_memory_allocated(device) - before)
            analysis = "allocator_peak"
    except Exception:
        pass
    plan = {
        "analysis": analysis,
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": temp_b,
        "alias_bytes": alias_b,
        "code_bytes": None,
    }
    if len(_recent_plans) < MAX_PLANS or label in _recent_plans:
        _recent_plans[label] = plan
    event = None
    if writer is not None:
        event = writer.emit("hbm_plan", step=step, label=str(label), **plan)
    return out, event


# OOM signatures across backends; matched case-insensitively against the
# exception text (the JAX package's markers)
_OOM_MARKERS = (
    "resource_exhausted",
    "out of memory",
    "allocation failure",
    "failed to allocate",
    "oom",
)


def is_oom_error(exc: BaseException) -> bool:
    """Whether an exception is a device allocation failure:
    ``torch.OutOfMemoryError``, or a text that says so (CUDA's "out of
    memory" ``RuntimeError`` among them)."""
    torch = sys.modules.get("torch")
    oom_type = getattr(torch, "OutOfMemoryError", None) if torch is not None else None
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(m in text for m in _OOM_MARKERS)


def dump_oom(
    writer,
    exc: BaseException,
    *,
    step: int | None = None,
    params_bytes: int | None = None,
    opt_bytes: int | None = None,
    device=None,
) -> dict | None:
    """Emit the ``hbm_oom_dump`` forensic snapshot: the failure text, the
    live watermark of ``device`` (default the current CUDA device), every
    tensor on that device's type that Python holds, grouped by (shape,
    dtype), top ``MAX_OOM_BUFFERS`` by bytes, and the plans this process
    emitted.  Called on the way down; never raises."""
    if writer is None:
        return None
    try:
        import gc

        from ddl_tpu_torch.utils.memory import hbm_stats

        torch = sys.modules.get("torch")
        mem = hbm_stats(device)
        kind = "cuda" if device is None else str(device).split(":")[0]
        groups: dict[tuple, list] = {}
        if torch is not None:
            for obj in gc.get_objects():
                try:
                    # type(), not isinstance: a deprecated object warns on __class__
                    if not issubclass(type(obj), torch.Tensor) or obj.device.type != kind:
                        continue
                    key = (tuple(obj.shape), str(obj.dtype).replace("torch.", ""))
                    cell = groups.setdefault(key, [0, 0])
                    cell[0] += 1
                    cell[1] += obj.numel() * obj.element_size()
                except Exception:
                    continue
        buffers = sorted(
            (
                {"shape": list(shape), "dtype": dtype, "count": count, "bytes": nbytes}
                for (shape, dtype), (count, nbytes) in groups.items()
            ),
            key=lambda b: (-b["bytes"], b["dtype"], b["shape"]),
        )[:MAX_OOM_BUFFERS]
        return writer.emit(
            "hbm_oom_dump",
            step=step,
            error=str(exc)[:500],
            watermark=mem["bytes_in_use"] if mem else None,
            limit=(mem["bytes_limit"] or None) if mem else None,
            params_bytes=params_bytes,
            opt_bytes=opt_bytes,
            buffers=buffers,
            plans=dict(_recent_plans),
        )
    except Exception:
        return None
