"""The port's corpus builder (ddl_tpu_torch/tools/repo_corpus.py) against
the JAX package's: byte-identical output for the same tree, with the
skip-list applied relative to the root (a tree that itself lives under a
``venv`` directory still harvests), extensions matched case-blind, and
``max_bytes`` stopping after the file that reaches it; plus ``main``'s
flags."""

from pathlib import Path

import pytest

from ddl_tpu.tools import repo_corpus as jax_repo_corpus
from ddl_tpu_torch.tools import repo_corpus

FILES = {
    "README.md": b"# tiny tree\n",
    "pkg/__init__.py": b"",
    "pkg/mod.py": b"def f():\n    return 1\n",
    "pkg/kernel.CPP": b"int main() { return 0; }\n",
    "pkg/data.bin": b"\x00\x01\x02",  # not an extension the corpus takes
    "pkg/__pycache__/mod.cpython-312.pyc": b"\x00",
    "pkg/__pycache__/notes.txt": b"skipped: inside a skip dir\n",
    "training_logs/by_job_id/x/loss.csv": b"1,2\n",
    "training_logs/readme.txt": b"skipped too\n",
    "docs/guide.md": "unicode: éè →\n".encode(),
    "docs/conf.toml": b"[tool]\nx = 1\n",
    "docs/deep/a.json": b'{"a": 1}\n',
    "docs/deep/b.yaml": b"b: 2\n",
}


def _tree(root: Path) -> Path:
    for rel, data in FILES.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    return root


@pytest.mark.parametrize("under", ["plain", "venv"])
def test_corpus_is_byte_identical_to_jax(tmp_path, under):
    root = _tree(tmp_path / under / "tree")
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    n = repo_corpus.build_corpus(root, got)
    assert n == jax_repo_corpus.build_corpus(root, want)
    assert got.read_bytes() == want.read_bytes()
    assert n == len(got.read_bytes())
    text = got.read_bytes()
    assert b"===== pkg/kernel.CPP =====" in text and b"===== docs/deep/b.yaml =====" in text
    assert b"skipped" not in text and b"data.bin" not in text and b"loss.csv" not in text


@pytest.mark.parametrize("max_bytes", [1, 60, 10**6])
def test_max_bytes_stops_where_jax_does(tmp_path, max_bytes):
    root = _tree(tmp_path / "tree")
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    n = repo_corpus.build_corpus(root, got, max_bytes)
    assert n == jax_repo_corpus.build_corpus(root, want, max_bytes)
    assert got.read_bytes() == want.read_bytes()
    full = repo_corpus.build_corpus(root, tmp_path / "full.txt")
    assert n == full if max_bytes > full else max_bytes <= n < full


def test_main_writes_the_corpus(tmp_path, capsys):
    root = _tree(tmp_path / "tree")
    out = tmp_path / "corpus.txt"
    repo_corpus.main(["--root", str(root), "--out", str(out), "--max-bytes", "0"])
    jax_repo_corpus.build_corpus(root, tmp_path / "jax.txt")
    assert out.read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert f"wrote {out.stat().st_size} bytes to {out}" in capsys.readouterr().out
