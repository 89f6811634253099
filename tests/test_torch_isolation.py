"""The port stands alone: no module of ddl_tpu_torch/, not chip_smoke.py
and not kernel_probes.py imports JAX, Flax, Optax or the JAX package,
every port module imports with those made unimportable, and a CPU tensor
through a kernel wrapper takes the plain version without counting a
launch."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    quant_decode_attention,
    quant_decode_attention_plain,
)
from ddl_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_dkdv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_with_lse,
    flash_attention_with_lse_plain,
)
from ddl_tpu_torch.ops.fused_dense_block import (
    fused_dense_block,
    fused_dense_block_plain,
    pack_block_params,
)
from ddl_tpu_torch.ops.image_kernel import normalize, normalize_plain
from ddl_tpu_torch.ops.int8_matvec import int8_matmul_small_m, int8_matmul_small_m_plain

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "ddl_tpu"}
SOURCES = sorted((ROOT / "ddl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                              ROOT / "kernel_probes.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_cover_the_entry_points_and_tools():
    """The scan reaches every subpackage, the command-line entry points
    and offline tools included."""
    names = {p.relative_to(ROOT / "ddl_tpu_torch").as_posix() for p in SOURCES[:-2]}
    assert {"examples/__init__.py", "examples/train_lm.py", "examples/generate_lm.py",
            "tools/__init__.py", "tools/repo_corpus.py",
            "bench/decode_quality.py"} <= names
    packages = {p.parent for p in (ROOT / "ddl_tpu_torch").rglob("__init__.py")}
    assert {p.parent for p in SOURCES[:-2]} == packages


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ddl_tpu_import(path):
    assert not _imported_roots(path) & BANNED


def test_every_port_module_imports_without_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "ddl_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for name in {sorted(BANNED)!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cpu_tensors_take_the_plain_versions():
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 5, 5, 3),
                                                                dtype=np.uint8))
    rng = np.random.default_rng(1)
    layers = []
    for i in range(2):
        c = 32 + 32 * i
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
        layers.append({"norm1.weight": f(c), "norm1.bias": f(c), "norm1.running_mean": f(c),
                       "norm1.running_var": f(c).abs() + 0.5, "conv1.weight": f(128, c, 1, 1),
                       "norm2.weight": f(128), "norm2.bias": f(128), "norm2.running_mean": f(128),
                       "norm2.running_var": f(128).abs() + 0.5, "conv2.weight": f(32, 128, 3, 3)})
    packed = pack_block_params(layers, torch.bfloat16)
    x0 = torch.from_numpy(rng.standard_normal((1, 4, 4, 32)).astype(np.float32)).to(torch.bfloat16)
    counts = (normalize.launches, fused_dense_block.launches)
    torch.testing.assert_close(normalize(images), normalize_plain(images), rtol=0, atol=0)
    torch.testing.assert_close(fused_dense_block(x0, packed),
                               fused_dense_block_plain(x0, packed), rtol=0, atol=0)
    assert (normalize.launches, fused_dense_block.launches) == counts == (0, 0)


def test_cpu_tensors_take_the_attention_plain_versions():
    rng = np.random.default_rng(2)

    def f(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)

    q, k, v = f(2, 16, 4, 64), f(2, 16, 2, 64), f(2, 16, 2, 64)
    q1, ck, cv = f(2, 1, 4, 64), f(2, 16, 128), f(2, 16, 128)
    bias = torch.zeros(1, 16)
    kq = torch.from_numpy(rng.integers(-127, 128, (2, 16, 128), dtype=np.int8))
    scales = torch.from_numpy(rng.random((2, 2, 16)).astype(np.float32))
    counts = (flash_attention_with_lse.launches, decode_attention.launches,
              quant_decode_attention.launches)
    for got, want in zip(flash_attention_with_lse(q, k, v, causal=True),
                         flash_attention_with_lse_plain(q, k, v, causal=True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(decode_attention(q1, ck, cv, bias, hkv=2),
                               decode_attention_plain(q1, ck, cv, bias, hkv=2), rtol=0, atol=0)
    torch.testing.assert_close(
        quant_decode_attention(q1, kq, scales, kq, scales, bias, hkv=2),
        quant_decode_attention_plain(q1, kq, scales, kq, scales, bias, hkv=2), rtol=0, atol=0)
    assert (flash_attention_with_lse.launches, decode_attention.launches,
            quant_decode_attention.launches) == counts == (0, 0, 0)


def test_cpu_backward_takes_the_plain_backward():
    """Gradients through ``flash_attention_with_lse`` on CPU tensors come
    from ``flash_attention_bwd_plain`` (bit for bit), and neither backward
    kernel's counter moves."""
    rng = np.random.default_rng(3)

    def f(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)

    q, k, v, do = f(2, 16, 4, 64), f(2, 16, 2, 64), f(2, 16, 2, 64), f(2, 16, 4, 64)
    dlse = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    counts = (flash_attention_with_lse.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkdv.launches)
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_with_lse(qt, kt, vt, causal=True)
    got = torch.autograd.grad((out, lse), (qt, kt, vt), (do, dlse))
    want = flash_attention_bwd_plain(q, k, v, out.detach(), lse.detach(), do, dlse, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (flash_attention_with_lse.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkdv.launches) == counts == (0, 0, 0)


def test_cpu_tensors_take_the_int8_matmul_plain_version():
    """Both layouts, bf16 and f32: bit-equal to the plain version, no launch
    counted; a tensor on neither the CPU nor a card is refused."""
    rng = np.random.default_rng(4)
    w8 = torch.from_numpy(rng.integers(-127, 128, (48, 80), dtype=np.int8))
    scale = torch.from_numpy(rng.random(80).astype(np.float32))
    count = int8_matmul_small_m.launches
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.standard_normal((5, 48)).astype(np.float32)).to(dtype)
        torch.testing.assert_close(int8_matmul_small_m(x, w8, scale),
                                   int8_matmul_small_m_plain(x, w8, scale), rtol=0, atol=0)
        xt = torch.from_numpy(rng.standard_normal((5, 80)).astype(np.float32)).to(dtype)
        torch.testing.assert_close(
            int8_matmul_small_m(xt, w8, scale[:48], contract_last=True),
            int8_matmul_small_m_plain(xt, w8, scale[:48], contract_last=True),
            rtol=0, atol=0)
    assert int8_matmul_small_m.launches == count == 0
    with pytest.raises(ValueError, match="unsupported device"):
        int8_matmul_small_m(torch.zeros(2, 48, device="meta"), w8.to("meta"),
                            scale.to("meta"))
