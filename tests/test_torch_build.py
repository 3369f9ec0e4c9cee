"""`kernels._build.build_source` on the CPU, with g++ standing in for
nvcc (the card's flags dropped): a source is built once into the build
directory, named by the hash of the source and the flags, its compiler
report kept and returned again when the build is loaded; other flags or
an edited source give another build; a failing compile raises with the
compiler's output."""

import ctypes
import shutil

import pytest

from wavespec_tpu_torch.kernels import _build

SOURCE = 'extern "C" int answer() { return ANSWER; }\n'


@pytest.fixture
def gxx_build(tmp_path, monkeypatch):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    calls = []

    def compiler():
        calls.append(1)
        return gxx

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "BASE_FLAGS", ("-shared", "-fPIC", "-x", "c++"))
    monkeypatch.setattr(_build, "_nvcc", compiler)
    return tmp_path, calls


def test_build_source_builds_once_and_keeps_its_report(gxx_build):
    tmp_path, calls = gxx_build
    src = tmp_path / "kernel.cu"
    src.write_text(SOURCE)
    lib, report = _build.build_source(src, ("-DANSWER=42", "-Wall"))
    lib.answer.restype = ctypes.c_int
    assert lib.answer() == 42 and len(calls) == 1
    again, report_again = _build.build_source(src, ("-DANSWER=42", "-Wall"))
    assert len(calls) == 1 and report_again == report
    built = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert len(built) == 2 and built[0].startswith("libkernel-") and built[1].endswith(".so")
    other, _ = _build.build_source(src, ("-DANSWER=7",))
    other.answer.restype = ctypes.c_int
    assert other.answer() == 7 and len(calls) == 2
    src.write_text(SOURCE + "// edited\n")
    _build.build_source(src, ("-DANSWER=7",))
    assert len(calls) == 3


def test_build_source_raises_with_the_compiler_output(gxx_build):
    tmp_path, _ = gxx_build
    src = tmp_path / "broken.cu"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="nvcc failed for broken.cu"):
        _build.build_source(src)
    assert [p for p in (tmp_path / "_build").iterdir()] == []
