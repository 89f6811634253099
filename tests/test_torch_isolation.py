"""The port stands alone: no module of ddl_tpu_torch/ and not chip_smoke.py
imports JAX, Flax, Optax or the JAX package, every port module imports
with those made unimportable, and a CPU tensor through a kernel wrapper
takes the plain version without counting a launch."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch.ops.fused_dense_block import (
    fused_dense_block,
    fused_dense_block_plain,
    pack_block_params,
)
from ddl_tpu_torch.ops.image_kernel import normalize, normalize_plain

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "ddl_tpu"}
SOURCES = sorted((ROOT / "ddl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


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
