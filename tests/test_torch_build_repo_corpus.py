"""The port's ``scripts/build_repo_corpus.py`` builds the JAX script's
corpus: the same file list (``GLOBS``, ``VAL_EVERY``) and, through the
port's ``train/datasets.convert_text``, ``train.dlc``, ``val.dlc`` and the
tokenizer sidecar byte-identical to ``scripts/build_repo_corpus.py``'s on
the same tree, at a small ``--seq_len``."""

import importlib.util
from pathlib import Path

import pytest

from deeplearning_cfn_tpu_torch.scripts import build_repo_corpus as corpus

REPO = Path(__file__).resolve().parent.parent


def _jax_script():
    try:
        import deeplearning_cfn_tpu.train.datasets  # noqa: F401
    except ImportError:
        pytest.skip("needs the JAX package, the reference")
    spec = importlib.util.spec_from_file_location("jax_build_repo_corpus",
                                                  REPO / "scripts" / "build_repo_corpus.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_corpus_is_byte_identical_to_the_jax_scripts(tmp_path):
    jax = _jax_script()
    assert (corpus.GLOBS, corpus.VAL_EVERY) == (jax.GLOBS, jax.VAL_EVERY)
    assert corpus.collect_files() == jax.collect_files()
    ours = corpus.main(["--out", str(tmp_path / "port"), "--seq_len", "64"])
    theirs = jax.main(["--out", str(tmp_path / "jax"), "--seq_len", "64"])
    assert ours["train"]["records"] == theirs["train"]["records"]
    assert ours["val"]["files"] == theirs["val"]["files"] > 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert {"train.dlc", "val.dlc"} <= set(names)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
