"""mlmc_tpu_torch.ops._build names each library by what goes into it, so an
edited source or header rebuilds. No nvcc is needed: only the names are
computed."""
import pytest

from mlmc_tpu_torch.ops import _build


@pytest.fixture
def source_dir(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_bytes(b'#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_bytes(b"// v1\n")
    monkeypatch.setattr(_build, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_header_change_renames_the_library(source_dir):
    first = _build.library_path("kern")
    assert _build.library_path("kern") == first
    (source_dir / "shared.cuh").write_bytes(b"// v2\n")
    assert _build.library_path("kern") != first
    (source_dir / "shared.cuh").write_bytes(b"// v1\n")
    assert _build.library_path("kern") == first


def test_source_and_new_header_rename_the_library(source_dir):
    first = _build.library_path("kern")
    (source_dir / "other.cuh").write_bytes(b"// another header\n")
    second = _build.library_path("kern")
    assert second != first
    (source_dir / "kern.cu").write_bytes(b'#include "shared.cuh"\n// edit\n')
    assert _build.library_path("kern") not in (first, second)
    assert _build.library_path("kern").parent == source_dir / "_build"


def test_the_package_headers_are_hashed():
    """The shipped sources include moment_gram.cuh, which the hash sees."""
    headers = sorted(p.name for p in _build.SOURCE_DIR.glob("*.cuh"))
    assert "moment_gram.cuh" in headers
    for name in ("synth_mlmc", "samples_mlmc"):
        text = (_build.SOURCE_DIR / (name + ".cu")).read_text()
        assert '#include "moment_gram.cuh"' in text
