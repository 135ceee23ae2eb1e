"""The kernel build's cache key: a library is reused only while its source,
every ``csrc/*.cuh`` header and the nvcc flags are unchanged.  Runs on the
CPU (no nvcc needed): ``source_digest`` only hashes files."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text("int a;\n")
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cu").write_text("int other;\n")
    return tmp_path


def test_digest_is_stable(csrc):
    assert _build.source_digest("k", csrc) == _build.source_digest("k", csrc)


@pytest.mark.parametrize("edit", ["source", "header", "new_header",
                                  "renamed_header", "flags"])
def test_digest_changes_with_what_the_build_reads(csrc, edit):
    before = _build.source_digest("k", csrc)
    flags = _build.NVCC_FLAGS
    if edit == "source":
        (csrc / "k.cu").write_text('#include "a.cuh"\nint k2;\n')
    elif edit == "header":
        (csrc / "b.cuh").write_text("int b2;\n")
    elif edit == "new_header":
        (csrc / "c.cuh").write_text("int c;\n")
    elif edit == "renamed_header":
        (csrc / "b.cuh").rename(csrc / "z.cuh")
    else:
        flags = flags + ("-lineinfo",)
    assert _build.source_digest("k", csrc, flags) != before


def test_digest_ignores_other_sources(csrc):
    before = _build.source_digest("k", csrc)
    (csrc / "other.cu").write_text("int other2;\n")
    (csrc / "notes.txt").write_text("not a header\n")
    assert _build.source_digest("k", csrc) == before


def test_shipped_kernels_have_distinct_digests():
    names = ("census_csr", "census_tiles", "flash_attention")
    digests = {_build.source_digest(n) for n in names}
    assert len(digests) == len(names)
    assert all(len(d) == 16 for d in digests)
