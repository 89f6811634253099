#!/usr/bin/env python3
"""Where the time of the int8 kernels goes, on one NVIDIA GPU.

    python3 kernel_probes.py     # from the repo root; needs a CUDA card and nvcc

Timing-only variants of ``ddl_tpu_torch/csrc/decode_attention.cu``, each
with one phase of the int8 split kernel removed by a text substitution,
built beside the real library into ``build/kernel_probes/`` and timed in
one call at the 124M decode's variants B and C (device time of the split
kernel and the combine from the profiler, as ``chip_smoke.py`` measures
kernels); the int8 head (``csrc/int8_matvec.cu``, (O, D) at M = 1) at
other ring shapes than its plan's; and the host's time per call of a
``QDense`` and an ``LMHead`` with int8 weights against the same modules
with bf16 and f32 weights, called in alternation.  The variants compute
wrong results on purpose and are only timed; nothing here is a check.
"""

from __future__ import annotations

import ctypes
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from ddl_tpu_torch.models.transformer import LMConfig, LMHead, QDense  # noqa: E402
from ddl_tpu_torch.ops import _build  # noqa: E402
from ddl_tpu_torch.ops import decode_attention as da  # noqa: E402
from ddl_tpu_torch.ops import int8_matvec as im  # noqa: E402
from ddl_tpu_torch.ops.quant import quantize_q8  # noqa: E402

VARIANT_DIR = _build.BUILD_DIR.parent / "kernel_probes"

# phases of quant_decode_split_kernel, each removed by one substitution
SCORES = ("  for (int item = warp; item < hb * n_tiles; item += kSplitWarps) {",
          "  for (int item = warp; item < 0; item += kSplitWarps) {")
SOFTMAX = ("  for (int r = warp; r < hb * G; r += kSplitWarps) {",
           "  for (int r = warp; r < 0; r += kSplitWarps) {")
PV = ("    if (live) {\n#pragma unroll 2", "    if (live && n < 0) {\n#pragma unroll 2")
COPIES = [("      mbar_arrive_expect_tx(smem_u32(&bars[c]), 2 * min(kChunk, n - c * kChunk) * row);",
           "      ;"),
          ("  if (warp == 0) {\n    __syncwarp();", "  if (warp == 0 && n < 0) {\n    __syncwarp();"),
          ("    mbar_wait(smem_u32(&bars[t * 16 / kChunk]), 0);", ""),
          ("  for (int c = 0; c < n_chunks; ++c) mbar_wait(smem_u32(&bars[c]), 0);  // V landed",
           "")]
DECODE_VARIANTS = {"no scores": [SCORES], "no softmax": [SOFTMAX], "no P.V": [PV],
                   "no copies": COPIES, "copies only": [SCORES, SOFTMAX, PV]}
# (label, (B, L, H, Hkv, D, visible lengths)): chip_smoke.py's timed int8 caches
DECODE_SHAPES = (("variant B", (32, 1088, 12, 4, 64, [1024 + 32])),
                 ("variant C", (1, 1024, 12, 4, 64, [1024])))
# the head at M = 1: (stage rows, stages, CTAs)
HEAD_RINGS = ((32, 3, 264), (32, 4, 132), (32, 2, 396), (16, 4, 264))


def variant(name: str, tag: str, subs, signatures) -> ctypes.CDLL:
    """``csrc/<name>.cu`` with ``subs`` applied, built like the real one."""
    out_dir = VARIANT_DIR / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in (_build.BUILD_DIR.parents[1] / "ddl_tpu_torch" / "csrc").glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    src = (_build.BUILD_DIR.parents[1] / "ddl_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{tag}: the source no longer has {old!r}")
        src = src.replace(old, new)
    (out_dir / f"{name}.cu").write_text(src)
    lib_path = out_dir / f"{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / f"{name}.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def run_decode(lib, q, cache, bias, hkv: int, plan) -> None:
    ck, ks, cv, vs = cache
    b, _, h, d = q.shape
    out = torch.empty_like(q)
    ws = torch.empty(b * hkv * (h // hkv) * plan.splits * (d + 2), dtype=torch.float32,
                     device=q.device)
    err = lib.ddl_quant_decode_attention(
        0, q.data_ptr(), ck.data_ptr(), ks.data_ptr(), cv.data_ptr(), vs.data_ptr(),
        bias.data_ptr(), 0, out.data_ptr(), b, ck.shape[1], hkv, h // hkv, d,
        ctypes.c_float(1.0 / math.sqrt(d)), plan.heads, plan.keys, plan.splits, ws.data_ptr(),
        torch._C._cuda_getCurrentRawStream(0))
    if err:
        raise RuntimeError(f"decode variant: CUDA error {err}")


def decode_phases() -> None:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    libs = {"kernel": _build.load("decode_attention", da._SIGNATURES)}
    for label, subs in DECODE_VARIANTS.items():
        libs[label] = variant("decode_attention", label.replace(" ", "_").replace(".", ""), subs,
                              da._SIGNATURES)
    for label, (b, L, h, hkv, d, lens) in DECODE_SHAPES:
        copies = max(3, math.ceil(60e6 / cs.decode_work(b, L, h, hkv, d, True)[1]))
        xs = [cs.decode_inputs(gen, b, L, h, hkv, d, True, lens) for _ in range(copies)]
        plan = da.decode_split_plan(b, L, hkv, h // hkv, d, _build.sm_count(0))
        for name, lib in libs.items():
            busy, _, kernels = cs.measure(lambda a: run_decode(lib, a[0], a[1], a[2], hkv, plan),
                                          xs, iters=max(60, copies))
            split = sum(v for k, v in kernels.items() if "split" in k)
            combine = sum(v for k, v in kernels.items() if "combine" in k)
            print(f"int8 decode {label}, {name}: busy {busy * 1e3:.2f} us (split kernel "
                  f"{split * 1e3:.2f}, combine {combine * 1e3:.2f})", flush=True)
        del xs
        torch.cuda.empty_cache()


def head_rings() -> None:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    lib = im._lib()
    d, o = 768, 50304
    ws = [cs.matvec_inputs(gen, 1, d, o, torch.float32, True) for _ in range(3)]
    want = im.int8_matmul_small_m_plain(*ws[0], contract_last=True)
    for rows, stages, grid in HEAD_RINGS:
        items = []
        for x, w8, scale in ws:
            buf = ctypes.create_string_buffer(lib.ddl_int8_matvec_plan_bytes())
            _build.check(lib, lib.ddl_int8_matvec_prepare(
                ctypes.addressof(buf), 0, w8.data_ptr(), scale.data_ptr(), d, o, 1, 1, grid, 288,
                rows, stages, d), "head plan")
            items.append((x, buf, torch.empty(1, o, device="cuda")))

        def run(item):
            x, buf, out = item
            _build.check(lib, lib.ddl_int8_matvec_run(
                ctypes.addressof(buf), x.data_ptr(), 0, out.data_ptr(), 1,
                torch._C._cuda_getCurrentRawStream(0)), "head")

        run(items[0])
        torch.cuda.synchronize()
        rel = cs.row_rel_err(items[0][2], want)
        busy, _, _ = cs.measure(run, items, iters=30)
        print(f"int8 head (768 -> 50304, M = 1), {stages} stages of {rows} rows, {grid} CTAs: "
              f"{busy * 1e3:.2f} us (per-row rel err {rel:.1e})", flush=True)


def host_costs() -> None:
    """Host microseconds per module call, int8 against bf16 / f32 weights,
    the two called in alternation 2000 times (medians)."""
    g = torch.Generator().manual_seed(cs.SEED)
    w = torch.randn(768, 768, generator=g)
    hw = torch.randn(50304, 768, generator=g)
    dense8, dense16 = QDense(768, 768, torch.bfloat16), QDense(768, 768, torch.bfloat16)
    dense8.load_state_dict(dict(zip(("kernel", "scale"), quantize_q8(w, axis=0))))
    dense16.load_state_dict({"kernel": w})
    cfg = LMConfig(vocab_size=50304, d_model=768)
    head8, head32 = LMHead(cfg), LMHead(cfg)
    head8.load_state_dict(dict(zip(("kernel", "scale"), quantize_q8(hw, axis=1))))
    head32.load_state_dict({"kernel": hw})
    for m in (dense8, dense16, head8, head32):
        m.cuda()
    dense16.kernel.data = dense16.kernel.data.to(torch.bfloat16)  # as the generator casts it
    x = torch.randn(1, 1, 768, generator=g).to(torch.bfloat16).cuda()
    with torch.inference_mode():
        for name, (a, b) in {"QDense 768 -> 768": (dense8, dense16),
                             "LMHead 768 -> 50304": (head8, head32)}.items():
            for _ in range(50):
                a(x), b(x)
            torch.cuda.synchronize()
            ta, tb = [], []
            for _ in range(2000):
                t = time.perf_counter()
                a(x)
                ta.append(time.perf_counter() - t)
                t = time.perf_counter()
                b(x)
                tb.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            print(f"host per call, {name}, in alternation: int8 weights "
                  f"{sorted(ta)[1000] * 1e6:.2f} us, {'bf16' if b is dense16 else 'f32'} weights "
                  f"{sorted(tb)[1000] * 1e6:.2f} us (medians of 2000)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probes: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.smi()}")
    _build.build(["decode_attention", "int8_matvec"])
    decode_phases()
    head_rings()
    host_costs()
    return 0


if __name__ == "__main__":
    sys.exit(main())
