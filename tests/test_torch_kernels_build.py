"""The key of a built kernel library (`voicebox_tpu_torch.kernels`): a hash of
the source, of the headers it includes and of the flags. These tests need
no nvcc: they edit copies of `csrc/` and replace the compiler with a stub.
"""

import shutil
import subprocess
from pathlib import Path

import pytest

from voicebox_tpu_torch import kernels

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(CSRC, dst)
    return dst


def _append(path: Path, text: str) -> None:
    path.write_text(path.read_text() + text)


@pytest.mark.parametrize("name", ["flash_attention_fwd", "flash_attention_bwd"])
def test_digest_moves_with_the_shared_header(csrc, name):
    src = csrc / f"{name}.cu"
    before = kernels.source_digest(src)
    assert kernels.source_digest(src) == before  # stable
    assert before == kernels.source_digest(CSRC / f"{name}.cu")  # the same bytes elsewhere
    _append(csrc / "hopper.cuh", "\n// an edit\n")
    after = kernels.source_digest(src)
    assert after != before
    _append(src, "\n// an edit\n")
    assert kernels.source_digest(src) not in (before, after)


def test_digest_ignores_a_header_the_source_does_not_include(csrc):
    src = csrc / "w8a16_matmul.cu"
    before = kernels.source_digest(src)
    _append(csrc / "hopper.cuh", "\n// an edit\n")
    assert kernels.source_digest(src) == before


def test_digest_follows_nested_includes_once(csrc):
    (csrc / "inner.cuh").write_text("// inner\n")
    _append(csrc / "hopper.cuh", '\n#include "inner.cuh"\n#include "inner.cuh"\n')
    src = csrc / "flash_attention_bwd.cu"
    before = kernels.source_digest(src)
    _append(csrc / "inner.cuh", "// an edit\n")
    assert kernels.source_digest(src) != before


def test_build_rebuilds_when_a_header_changes(csrc, tmp_path, monkeypatch):
    calls = []

    def fake_nvcc(cmd, **kw):
        out = Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"library")
        calls.append(cmd[-1])
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info\n", stderr="")

    monkeypatch.setattr(kernels, "_CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", fake_nvcc)
    first = kernels.build("flash_attention_bwd")
    assert kernels.build("flash_attention_bwd") == first and len(calls) == 1  # cached
    _append(csrc / "hopper.cuh", "\n// an edit\n")
    second = kernels.build("flash_attention_bwd")
    assert second != first and second.exists() and len(calls) == 2
    assert Path(f"{second}.log").read_text() == "ptxas info\n"
