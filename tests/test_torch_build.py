"""The kernel builder names each library by its source and the headers it
includes, so an edited header rebuilds every source that includes it."""

import os

import pytest

from flash_attention_from_scratch_tpu_torch.ops import _build


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    _write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n#include "tile.cuh"\nint k;\n')
    _write(tmp_path / "tile.cuh", '#pragma once\n  #  include "inner.cuh"\nint t;\n')
    _write(tmp_path / "inner.cuh", "int i;\n")
    _write(tmp_path / "other.cu", "int o;\n")
    first = _build._target("k.cu")[1]
    other = _build._target("other.cu")[1]
    assert os.path.basename(first).startswith("k_")

    _write(tmp_path / "inner.cuh", "int i2;\n")  # a header two levels down
    second = _build._target("k.cu")[1]
    assert second != first
    assert _build._target("other.cu")[1] == other  # includes nothing: unchanged

    _write(tmp_path / "k.cu", '#include "tile.cuh"\n#include "tile.cuh"\nint k;\n')
    assert _build._target("k.cu")[1] != second


def test_build_hash_fails_on_a_missing_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    _write(tmp_path / "k.cu", '#include "absent.cuh"\n')
    with pytest.raises(FileNotFoundError):
        _build._target("k.cu")


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(_build._CSRC) if n.endswith((".cu", ".cpp"))))
def test_every_source_resolves_its_headers(name):
    """Each shipped source hashes, so every header it includes is shipped."""
    src, so = _build._target(name)
    assert os.path.exists(src) and so.endswith(".so")
