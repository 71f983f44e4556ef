"""ray_tpu_torch.native: the library name is a content hash of its source,
the shared headers under csrc/ and the nvcc flags, so editing any of them
rebuilds and nothing else does. No nvcc is needed: only the paths are
computed."""

import os

import pytest

from ray_tpu_torch import native


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of two sources and one shared header in a temporary
    directory."""
    for name, text in (("a.cu", '#include "shared.cuh"\nint a;\n'),
                       ("b.cu", "int b;\n"),
                       ("shared.cuh", "#pragma once\n")):
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(native, "CSRC_DIR", str(tmp_path))
    return tmp_path


def test_lib_path_is_stable_and_per_source(csrc):
    assert native.sources() == ["a", "b"]
    assert native._lib_path("a") == native._lib_path("a")
    assert native._lib_path("a") != native._lib_path("b")
    assert os.path.dirname(native._lib_path("a")) == native.BUILD_DIR


@pytest.mark.parametrize("edit", ["header", "source", "new_header"])
def test_lib_path_changes_when_a_build_input_changes(csrc, edit):
    """Editing the shared header, the source, or adding a header gives the
    library a new name; an edit to another source does not."""
    before = native._lib_path("a")
    (csrc / "b.cu").write_text("int b2;\n")
    assert native._lib_path("a") == before
    if edit == "header":
        (csrc / "shared.cuh").write_text("#pragma once\n#define X 1\n")
    elif edit == "source":
        (csrc / "a.cu").write_text('#include "shared.cuh"\nint a2;\n')
    else:
        (csrc / "other.cuh").write_text("#pragma once\n")
    assert native._lib_path("a") != before


def test_lib_path_changes_with_flags(csrc, monkeypatch):
    before = native._lib_path("a")
    monkeypatch.setattr(native, "NVCC_FLAGS", (*native.NVCC_FLAGS, "-lineinfo"))
    assert native._lib_path("a") != before
