"""How the hand-written kernels' libraries are named, on the CPU.

``_build.library_path`` names a library by a hash of its ``.cu``, every
header in ``csrc/`` and the compiler's flags, so that a library built before
an edit is never loaded after it. The kernels' libraries include
``csrc/common.cuh``, so an edited header has to name new libraries too.
"""

from rank_tpu_torch.ops.kernels import _build


def test_an_edited_header_names_a_new_library(tmp_path, monkeypatch):
    (tmp_path / "kernel.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// before\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("kernel")
    assert _build.library_path("kernel") == before
    header.write_text("// after\n")
    assert _build.library_path("kernel") != before
