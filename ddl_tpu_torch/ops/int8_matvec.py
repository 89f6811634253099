"""Weight-only int8 matmul for tiny-M decode steps: the CUDA kernel and its
plain version (counterpart of ``ddl_tpu/ops/int8_matvec.py``).

The CUDA source ``ddl_tpu_torch/csrc/int8_matvec.cu`` replaces the TPU
kernel ``ddl_tpu/ops/int8_matvec.py:39`` (``_kernel``, reached through
``int8_matmul_small_m``).  On the TPU, XLA fuses the int8 -> bf16 convert
into the matmul's operand read, and that lowering beat the Pallas kernel,
so the JAX package leaves the kernel unwired.  The card has no such
fusion: ``x @ w8.to(bf16)`` reads each weight byte, writes a 2-byte copy
and reads the copy again.  So here the kernel is the only path that
streams the int8 weights at one byte each, and ``QDense`` and ``LMHead``
(``models/transformer.py``) take it for every product of at most
``MATVEC_MAX_ROWS`` activation rows.

Bound on the H100: bytes, and at the 124M's layer sizes latency, on the
host as much as on the card.  A decode token makes 73 calls, so the host
side is built once per weight: ``Int8MatmulLaunch`` checks the weight,
computes its ``MatvecPlan`` and lets the C side fill a plan buffer (the
pointers and, for (D, O), the TMA tensor map); a call then checks x and
makes one ctypes call.  ``_Int8Weight`` keeps one per module and builds a
new one when its weight or scale is replaced (a load, a device move).
The free function ``int8_matmul_small_m`` keeps its full checks and builds
a launch state per call.  Device side: the (D, O) layout on the tensor
cores (mma.sync, the weight streamed by TMA, D split over a cluster of 8
CTAs whose sums meet in rank order through distributed shared memory);
the (O, D) head on the CUDA cores in exact f32, a persistent grid with a
producer warp streaming contiguous row blocks by bulk copy into a ring
(``int8_matvec.cu`` has the full note).  The TPU-only arguments
``block_o`` (the MXU lane tile) and ``interpret`` are gone: the kernel
takes any O and D.

Numerics follow the TPU kernel: the int8 values are exact, the products
are exact (bf16 x int8 in f32 on the tensor cores; an f32 x in (D, O) as
three bf16 terms; the f32 head on CUDA cores), the sums are f32, the
per-channel scale multiplies the f32 sum, and the result is rounded once
to x's dtype (bf16 in, bf16 out; f32 in, f32 out, as the head needs).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ddl_tpu_torch.ops import _build
from ddl_tpu_torch.ops._build import H100_SMS, SMEM_PER_BLOCK

__all__ = [
    "MATVEC_MAX_ROWS",
    "Int8MatmulLaunch",
    "MatvecPlan",
    "int8_kernel_takes",
    "int8_matmul_small_m",
    "int8_matmul_small_m_plain",
    "matvec_plan",
]

MATVEC_MAX_ROWS = 8
_SIGNATURES = {
    "ddl_int8_matvec_plan_bytes": [],
    "ddl_int8_matvec_prepare": [
        ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 2, *[ctypes.c_int] * 9,
    ],
    "ddl_int8_matvec_smem": [ctypes.c_void_p, ctypes.c_int],
    "ddl_int8_matvec_run": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ],
}
_X_DTYPES = (torch.bfloat16, torch.float32)
# The kernels' geometry (csrc/int8_matvec.cu): (D, O) a
# cluster of 8 CTAs per 64-column strip, of 4 warps (8 from 12 16-row steps
# a rank, where more warps shorten the longer loop), TMA boxes of 32 rows;
# (O, D) two CTAs an SM, each of 8 consumer warps and a producer, 4 rows a
# consumer pass, a ring of 3 stages of up to 32 rows (a pass for each
# consumer) and ~24 KB each (at the 124M head 3 stages at two CTAs an SM
# beat 4 at one: kernel_probes.py times both), each consumer's scales 4
# stages ahead.
_CLUSTER, _STRIP, _BOX_ROWS, _WIDE_STEPS = 8, 64, 32, 12
_OD_CONSUMERS, _OD_ROWS, _OD_STAGES, _OD_STAGE_BYTES, _OD_AHEAD = 8, 4, 3, 24576, 4
_OD_CTAS_PER_SM = 2
_ALIGN_SLACK = 128


@dataclasses.dataclass(frozen=True)
class MatvecPlan:
    """The launch geometry of one weight.  (D, O): ``grid`` strips of 64
    output columns, each a cluster of 8 CTAs splitting D into ``rows``-row
    slices (``rows // 32`` TMA boxes each).  (O, D): a persistent grid of
    ``grid`` CTAs, each streaming its rows through ``stages`` ring stages
    of ``rows`` rows of ``pitch`` bytes (D rounded up to 16), two CTAs an
    SM."""

    contract_last: bool
    grid: int
    threads: int
    rows: int
    stages: int
    pitch: int

    @property
    def ctas(self) -> int:
        return self.grid if self.contract_last else self.grid * _CLUSTER

    def smem(self, m: int) -> int:
        """Dynamic shared memory of a launch at ``m`` rows of x (the C
        side's ``do_smem`` / ``od_smem``)."""
        if self.contract_last:
            return (_ALIGN_SLACK + self.stages * self.rows * self.pitch + 4 * m * self.pitch
                    + 4 * _OD_CONSUMERS * _OD_AHEAD * _OD_ROWS + 16 * self.stages)
        return (_ALIGN_SLACK + self.rows * _STRIP + 4 * MATVEC_MAX_ROWS * (self.rows + 4)
                + 4 * (self.threads // 32) * MATVEC_MAX_ROWS * _STRIP
                + 4 * _CLUSTER * MATVEC_MAX_ROWS * (_STRIP // _CLUSTER)
                + 8 * (1 + self.rows // _BOX_ROWS))


@functools.lru_cache(maxsize=None)
def matvec_plan(d: int, o: int, contract_last: bool, sms: int = H100_SMS) -> MatvecPlan:
    """The kernel's plan for a (D, O) or (O, D) int8 weight on a card of
    ``sms`` SMs; its shared memory depends on D (and M) only."""
    if contract_last:
        pitch = -(-d // 16) * 16
        rows = min(_OD_CONSUMERS * _OD_ROWS,
                   max(_OD_ROWS, _OD_STAGE_BYTES // (_OD_ROWS * pitch) * _OD_ROWS))
        grid = max(1, min(_OD_CTAS_PER_SM * sms, -(-o // _OD_ROWS)))
        return MatvecPlan(True, grid, 32 * (_OD_CONSUMERS + 1), rows, _OD_STAGES, pitch)
    rows = -(-d // (_CLUSTER * _BOX_ROWS)) * _BOX_ROWS
    warps = 8 if rows // 16 >= _WIDE_STEPS else 4
    return MatvecPlan(False, -(-o // _STRIP), 32 * warps, rows, rows // _BOX_ROWS, 0)


def int8_kernel_takes(m: int, d: int, contract_last: bool, dtype, device_type: str) -> bool:
    """Whether an (M, D) product with the int8 weight in the given layout
    goes through ``int8_matmul_small_m``: at most ``MATVEC_MAX_ROWS`` rows
    anywhere (the plain version takes every such shape); on CUDA also a
    bf16 or f32 x whose launch fits the block's shared memory.  Call sites
    send what this refuses to the large-M product."""
    if m > MATVEC_MAX_ROWS:
        return False
    if device_type != "cuda":
        return True
    return dtype in _X_DTYPES and \
        matvec_plan(d, 1, contract_last).smem(max(m, 1)) <= SMEM_PER_BLOCK


def _check_args(x, w8, scale, contract_last: bool) -> int:
    """Shapes both paths require; returns O."""
    if x.dim() != 2:
        raise ValueError(f"int8_matmul_small_m takes x of shape (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    if m > MATVEC_MAX_ROWS:
        raise ValueError(f"M={m} > {MATVEC_MAX_ROWS}; use the large-M product")
    if w8.dim() != 2 or w8.shape[1 if contract_last else 0] != d:
        layout = "(O, D)" if contract_last else "(D, O)"
        raise ValueError(f"w8 {tuple(w8.shape)} is not {layout} with D={d}")
    o = w8.shape[0] if contract_last else w8.shape[1]
    if scale.numel() != o:
        raise ValueError(f"scale has {scale.numel()} elements, the output {o} channels")
    return o


def int8_matmul_small_m_plain(x, w8, scale, *, contract_last: bool = False):
    """The TPU kernel's arithmetic in one f32 product."""
    o = _check_args(x, w8, scale, contract_last)
    w = w8.float()
    y = x.float() @ (w.t() if contract_last else w)
    return (y * scale.float().reshape(1, o)).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return _build.load("int8_matvec", _SIGNATURES)


class Int8MatmulLaunch:
    """The launch state of one int8 weight: ``(x @ dequant(w8)) * scale``
    for x of at most ``MATVEC_MAX_ROWS`` rows, with the weight checked
    once.  On CUDA it holds the plan buffer the C side filled (the weight
    and scale pointers, the grid, the TMA map) and references to ``w8``
    and ``scale``, so the memory behind the pointers stays alive; a module
    asks ``matches`` before each use and builds a new state when its
    tensors were replaced.  A CPU weight gets the plain version."""

    __slots__ = ("w8", "scale", "contract_last", "d", "o", "device", "plan", "_buf", "_handle",
                 "_ptrs", "_run", "_max_m", "_index")

    def __init__(self, w8, scale, *, contract_last: bool = False) -> None:
        if w8.dim() != 2:
            raise ValueError(f"int8_matmul_small_m: w8 must be 2-D, got {tuple(w8.shape)}")
        self.w8, self.scale, self.contract_last = w8, scale, contract_last
        self.o, self.d = w8.shape if contract_last else (w8.shape[1], w8.shape[0])
        if scale.numel() != self.o:
            raise ValueError(f"scale has {scale.numel()} elements, the output {self.o} channels")
        self.device = w8.device
        self._index = w8.get_device()
        self._ptrs = (w8.data_ptr(), scale.data_ptr())
        self._max_m = 0
        if w8.device.type == "cpu":
            return
        if w8.device.type != "cuda":
            raise ValueError(f"int8_matmul_small_m kernel: unsupported device {w8.device}")
        if w8.dtype != torch.int8 or scale.dtype != torch.float32:
            raise ValueError(
                f"int8_matmul_small_m kernel takes an int8 w8 and f32 scale, got {w8.dtype} / "
                f"{scale.dtype}"
            )
        if scale.device != w8.device:
            raise ValueError(f"int8_matmul_small_m kernel: scale on {scale.device}, w8 on "
                             f"{w8.device}")
        if not w8.is_contiguous() or not scale.is_contiguous():
            raise ValueError("int8_matmul_small_m kernel: w8 and scale must be contiguous")
        index = w8.device.index if w8.device.index is not None else torch.cuda.current_device()
        self.plan = matvec_plan(self.d, self.o, contract_last, _build.sm_count(index))
        self._max_m = max((m for m in range(1, MATVEC_MAX_ROWS + 1)
                           if self.plan.smem(m) <= SMEM_PER_BLOCK), default=0)
        if self.o == 0 or self.d == 0:
            return
        vec = (self.d if contract_last else self.o) % 16 == 0 and w8.data_ptr() % 16 == 0
        lib = _lib()
        self._buf = ctypes.create_string_buffer(lib.ddl_int8_matvec_plan_bytes())
        self._handle = ctypes.addressof(self._buf)
        err = lib.ddl_int8_matvec_prepare(
            self._handle, index, w8.data_ptr(), scale.data_ptr(), self.d, self.o,
            int(contract_last), int(vec), self.plan.grid, self.plan.threads, self.plan.rows,
            self.plan.stages, self.plan.pitch)
        _build.check(lib, err, "int8_matmul_small_m plan")
        self._run = lib.ddl_int8_matvec_run

    def matches(self, w8, scale) -> bool:
        """Whether this state was built for exactly these tensors, at the
        memory they hold now."""
        return (w8 is self.w8 and scale is self.scale
                and (w8.data_ptr(), scale.data_ptr()) == self._ptrs)

    def take(self, x):
        """The product for x of shape (..., D), as (..., O), if the kernel
        takes it here (a contiguous bf16 or f32 x on the weight's card with
        at most as many rows as the launch stages: ``int8_kernel_takes``'s
        answer for this weight), else None.  The decode path's call: no
        reshapes, no checks of the weight."""
        if not self.d:
            return None
        m = x.numel() // self.d
        if (m > self._max_m or x.dtype not in _X_DTYPES or x.get_device() != self._index
                or x.shape[-1] != self.d or not x.is_contiguous()):
            return None
        out = x.new_empty((*x.shape[:-1], self.o))
        if m and self.o:
            self._launch(x, out, m)
        return out

    def _launch(self, x, out, m: int) -> None:
        err = self._run(self._handle, x.data_ptr(), x.dtype is torch.bfloat16, out.data_ptr(), m,
                        torch._C._cuda_getCurrentRawStream(self._index))
        if err:
            _build.check(_lib(), err, "int8_matmul_small_m kernel")
        int8_matmul_small_m.launches += 1

    def smem(self, m: int) -> int:
        """The C side's shared memory for a launch at ``m`` rows."""
        return _lib().ddl_int8_matvec_smem(self._handle, m)

    def __call__(self, x):
        if self.device.type == "cpu":
            return int8_matmul_small_m_plain(x, self.w8, self.scale,
                                             contract_last=self.contract_last)
        if x.get_device() != self._index:
            raise ValueError(f"int8_matmul_small_m kernel: x on {x.device}, w8 on {self.device}")
        if x.dtype not in _X_DTYPES:
            raise ValueError(f"int8_matmul_small_m kernel takes a bf16 or f32 x, got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != self.d or not x.is_contiguous():
            raise ValueError(f"int8_matmul_small_m kernel: x {tuple(x.shape)} is not a contiguous "
                             f"(M, {self.d})")
        m = x.shape[0]
        if m > self._max_m:
            raise ValueError(f"int8_matmul_small_m kernel: M={m} rows at D={self.d} is more than "
                             f"it stages (at most {self._max_m}); use the large-M product")
        out = x.new_empty((m, self.o))
        if m == 0 or self.o == 0:
            return out
        if self.d == 0:
            return out.zero_()
        self._launch(x, out, m)
        return out


def int8_matmul_small_m(x, w8, scale, *, contract_last: bool = False):
    """``(x @ dequant(w8)) * scale`` for M <= ``MATVEC_MAX_ROWS`` rows.

    x: (M, D) bf16 or f32; ``w8`` int8, (D, O) (``contract_last=False``:
    ``QDense``'s layout) or (O, D) (``True``: ``LMHead``'s vocab-major
    layout); ``scale`` f32 with exactly O elements (any shape).  Returns
    (M, O) in x's dtype.  M > 8 raises ``ValueError``.

    A CPU tensor goes through ``int8_matmul_small_m_plain``; a CUDA tensor
    launches the kernel on the current stream (no synchronisation) or
    raises.  Every call checks and plans the weight anew: a caller that
    multiplies by one weight many times keeps an ``Int8MatmulLaunch``."""
    _check_args(x, w8, scale, contract_last)
    if x.device.type == "cpu":
        return int8_matmul_small_m_plain(x, w8, scale, contract_last=contract_last)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_small_m kernel: unsupported device {x.device}")
    if w8.device != x.device:
        raise ValueError(f"int8_matmul_small_m kernel: w8 on {w8.device}, x on {x.device}")
    return Int8MatmulLaunch(w8, scale.reshape(-1), contract_last=contract_last)(x.contiguous())


int8_matmul_small_m.launches = 0
