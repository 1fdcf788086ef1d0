"""The kernel build driver on the CPU, with a stand-in for nvcc: one
compile per source, then one link; a failed source raises and leaves no
objects and no library behind; a built library is reused by hash."""

import os
import stat

import pytest

import lteax_torch.kernels._build as build

FAKE_NVCC = """#!/bin/sh
for a in "$@"; do
  case "$a" in *bad.cu) echo "bad.cu(1): error: stand-in"; exit 1;; esac
done
echo "nvcc $*"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo obj > "$2"; fi
  shift
done
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "KernelLibrary",
                        lambda path, build_s, log: (path, build_s, log))
    return csrc, out


def test_build_compiles_each_source_then_links(fake_toolkit):
    csrc, out = fake_toolkit
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// " + name)
    path, build_s, log = build.library.__wrapped__()
    assert path.exists() and build_s > 0.0
    lines = log.splitlines()
    assert [ln.split()[-1].rsplit("/", 1)[-1] for ln in lines[:2]] == \
        ["a.cu", "b.cu"]
    assert " -c " in lines[0] and " -shared " in lines[2]
    assert sorted(os.listdir(out)) == sorted([path.name,
                                              path.with_suffix(".log").name])
    again = build.library.__wrapped__()
    assert again == (path, 0.0, log)          # loaded by hash, not rebuilt


def test_build_failure_raises_and_leaves_nothing(fake_toolkit):
    csrc, out = fake_toolkit
    for name in ("a.cu", "bad.cu", "c.cu"):
        (csrc / name).write_text("// " + name)
    with pytest.raises(RuntimeError, match="bad.cu"):
        build.library.__wrapped__()
    assert os.listdir(out) == []
