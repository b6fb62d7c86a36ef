"""The kernel build's cache key (paddle_tpu_torch/ops/cuda/build.py): a
library is named by a hash of its source, of every csrc/*.cuh header and
of the flags, so an edit to a shared header rebuilds every source. No
nvcc is needed: the tests only name libraries."""
import os

import pytest

from paddle_tpu_torch.ops.cuda import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "helpers.cuh"\n')
    (src / "helpers.cuh").write_text("// helpers\n")
    monkeypatch.setattr(build, "CSRC", str(src))
    monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    return src


@pytest.mark.parametrize("edit,rebuilt", [
    (None, False),
    (("helpers.cuh", "// helpers, edited\n"), True),
    (("kern.cu", '#include "helpers.cuh"\n// edited\n'), True),
    (("more.cuh", "// a new header\n"), True),
])
def test_library_name_follows_source_and_headers(csrc, edit, rebuilt):
    before = build.library_path("kern")
    assert os.path.dirname(before) == build.build_dir()
    assert os.path.basename(before).startswith("kern-")
    if edit is not None:
        (csrc / edit[0]).write_text(edit[1])
    assert (build.library_path("kern") != before) == rebuilt


def test_build_finds_a_library_already_built(csrc):
    """An unchanged source whose library exists is loaded as it is: no
    nvcc run, empty log."""
    path = build.library_path("kern")
    os.makedirs(os.path.dirname(path))
    open(path, "wb").close()
    assert build.build("kern") == (path, "")
