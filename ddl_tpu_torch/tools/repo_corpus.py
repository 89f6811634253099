"""Build a byte-level LM corpus from a source tree (own copy of
``ddl_tpu/tools/repo_corpus.py``).

Turns any code/doc tree -- by default this repository itself -- into a
real text corpus for the byte-level LM (``data/lm_corpus.encode_text_file``
reads plain text; vocab 256 covers it by construction), so an offline
environment gets honest held-out perplexity curves on real data.

    python -m ddl_tpu_torch.tools.repo_corpus --out /tmp/repo_corpus.txt
    python -m ddl_tpu_torch.examples.train_lm --corpus /tmp/repo_corpus.txt --eval-every 25 ...

Files are concatenated in sorted order with a path header line, so the
corpus is deterministic for a given tree (byte-identical to the JAX
package's tool) and the model sees file boundaries as text structure.
Write the output outside the tree: a ``.txt`` inside it is harvested by
the next run.
"""

from __future__ import annotations

import argparse
from pathlib import Path

__all__ = ["EXTS", "SKIP_DIRS", "build_corpus", "iter_files", "main"]

# source + doc extensions; binaries and generated artifacts are skipped
EXTS = {".py", ".md", ".cpp", ".cc", ".h", ".hpp", ".toml", ".txt",
        ".json", ".sh", ".yaml", ".yml", ".cfg", ".ini"}
SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "checkpoints",
             "training_logs", "node_modules", ".venv", "venv"}


def iter_files(root: Path):
    for p in sorted(root.rglob("*")):
        if not p.is_file() or p.suffix.lower() not in EXTS:
            continue
        # the skip-list applies to directories INSIDE the tree, not to the
        # root's own ancestors (a tree under e.g. a venv must harvest)
        if any(part in SKIP_DIRS for part in p.relative_to(root).parts):
            continue
        yield p


def build_corpus(root: Path, out: Path, max_bytes: int = 0) -> int:
    """Write the corpus of ``root`` to ``out``; returns its bytes.  With
    ``max_bytes``, stops after the file that reaches it."""
    root, out = Path(root), Path(out)
    total = 0
    with out.open("wb") as f:
        for p in iter_files(root):
            try:
                data = p.read_bytes()
            except OSError:
                continue
            header = f"\n===== {p.relative_to(root)} =====\n".encode()
            f.write(header)
            f.write(data)
            total += len(header) + len(data)
            if max_bytes and total >= max_bytes:
                break
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=".",
                    help="tree to harvest (default: current directory)")
    ap.add_argument("--out", required=True, help="output text file")
    ap.add_argument("--max-bytes", type=int, default=0,
                    help="stop after this many bytes (0 = everything)")
    args = ap.parse_args(argv)
    n = build_corpus(Path(args.root), Path(args.out), args.max_bytes)
    print(f"wrote {n} bytes to {args.out}")


if __name__ == "__main__":
    main()
