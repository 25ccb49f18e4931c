"""Build the real-text LM corpus for ``llama_train --data_dir``: this
repository's own source and docs, byte-level tokenizer, fixed windows,
a DISJOINT FILE SPLIT (no val file contributes a train window, so
held-out perplexity is held out).

    python -m deeplearning_cfn_tpu_torch.scripts.build_repo_corpus --out DIR [--seq_len 1024]

Writes ``<DIR>/train.dlc`` and ``val.dlc`` with their sidecars, through
the port's ``train/datasets.convert_text``.  The file list (``GLOBS``,
``VAL_EVERY``) is the JAX package's ``scripts/build_repo_corpus.py``'s, so
on the same tree both give the same corpus, byte for byte, and a corpus
is rebuildable from the tree it names.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
from pathlib import Path

from deeplearning_cfn_tpu_torch.train.datasets import convert_text

REPO = Path(__file__).resolve().parents[2]

# Source + docs, no binaries, no goldens (JSON is near-random bytes at the
# byte level and pads perplexity down), no test fixtures.
GLOBS = ("deeplearning_cfn_tpu/**/*.py", "native/**/*.cpp", "native/**/*.h",
         "docs/*.md", "*.md", "scripts/*.py", "tests/*.py")
VAL_EVERY = 10  # every 10th file (sorted order) is val: ~9% of files


def collect_files(repo: Path = REPO) -> tuple[list[Path], list[Path]]:
    files = sorted({p for g in GLOBS for p in repo.glob(g) if p.is_file()})
    train = [p for i, p in enumerate(files) if i % VAL_EVERY != VAL_EVERY - 1]
    val = [p for i, p in enumerate(files) if i % VAL_EVERY == VAL_EVERY - 1]
    return train, val


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seq_len", type=int, default=1024)
    args = ap.parse_args(argv)

    train, val = collect_files()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stats = {}
    with tempfile.TemporaryDirectory() as td:
        for split, paths in (("train", train), ("val", val)):
            sdir = Path(td) / split
            sdir.mkdir()
            for p in paths:
                # Flat .txt copies: convert_text globs *.txt one level deep.
                shutil.copyfile(p, sdir / (str(p.relative_to(REPO)).replace("/", "__") + ".txt"))
            info = convert_text(sdir, out, seq_len=args.seq_len, split=split)
            stats[split] = {"files": len(paths), **info}
    print(stats)
    return stats


if __name__ == "__main__":
    main()
