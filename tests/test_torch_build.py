"""The build key of the port's CUDA libraries (``kernels/build.py``), on
the CPU: a library is rebuilt when a source or any header beside it
changes.  These tests hash copies of ``csrc/`` and call no ``nvcc``."""
import re
import shutil

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.cache_update import kernel as CK
from repro_torch.kernels.dequant_gemm import kernel as DK
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.fused_decode import kernel as K
from repro_torch.kernels.linear_attention import kernel as LK
from repro_torch.kernels.ssd import kernel as SK

LIBS = (K, FK, SK, LK, DK, CK)


@pytest.fixture
def csrc(tmp_path):
    """A copy of the sources, so the tests may edit it."""
    return shutil.copytree(build.CSRC, tmp_path / "csrc")


@pytest.mark.parametrize("lib", LIBS, ids=lambda m: m.LIBRARY)
def test_header_edit_changes_the_digest(csrc, lib):
    """Editing hopper.cuh changes every library's key (an edited header
    never loads a stale build), and the key of an unchanged copy is the
    checked-out tree's (it hashes contents, not paths)."""
    srcs = [csrc / s for s in lib.SOURCES]
    before = build._digest(srcs)
    assert before == build._digest([build.CSRC / s for s in lib.SOURCES])
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// one more line\n")
    assert build._digest(srcs) != before


def test_source_and_new_header_change_the_digest(csrc):
    srcs = [csrc / s for s in FK.SOURCES]
    before = build._digest(srcs)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    with_header = build._digest(srcs)
    assert with_header != before
    srcs[0].write_text(srcs[0].read_text() + "\n")
    assert build._digest(srcs) != with_header


def test_every_include_of_a_source_is_a_hashed_header():
    """Each quoted #include of a library's sources names a ``*.cuh`` in
    ``csrc/`` (the files ``_digest`` hashes beside the sources)."""
    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    assert "hopper.cuh" in headers
    for lib in LIBS:
        for s in lib.SOURCES:
            text = (build.CSRC / s).read_text()
            for inc in re.findall(r'#include\s+"([^"]+)"', text):
                assert inc in headers, f"{s} includes {inc}"


def test_out_dir_is_keyed_on_the_digest():
    out = build._out_dir(DK.LIBRARY, DK.SOURCES)
    digest = build._digest([build.CSRC / s for s in DK.SOURCES])
    assert out == build.BUILD_ROOT / f"{DK.LIBRARY}-{digest}"
