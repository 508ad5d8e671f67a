"""The port's kernel build (``repro_torch.kernels.build``) on the CPU.

A library is named by a tag that hashes its ``.cu`` source, every shared
header ``csrc/*.cuh`` and the nvcc flags, so that an edited header is
rebuilt rather than loaded stale. These tests run against a temporary
``csrc`` directory and never call nvcc: the build step is replaced by a
stub that records what it was asked to compile.
"""

import pathlib

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "one.cu").write_text('#include "shared.cuh"\nint one;\n')
    (d / "two.cu").write_text("int two;\n")
    (d / "shared.cuh").write_text("#pragma once\nint shared;\n")
    (d / "notes.txt").write_text("not a source\n")
    monkeypatch.setattr(build, "CSRC", d)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return d


def test_tag_is_stable_when_nothing_changes(csrc):
    tags = {build._tag(csrc / "one.cu") for _ in range(3)}
    assert len(tags) == 1
    assert build._tag(csrc / "one.cu") != build._tag(csrc / "two.cu")


@pytest.mark.parametrize("edit", ["header bytes", "new header",
                                  "header removed", "source bytes",
                                  "flags"])
def test_tag_changes_with_what_the_build_reads(csrc, monkeypatch, edit):
    before = build._tag(csrc / "one.cu")
    if edit == "header bytes":
        (csrc / "shared.cuh").write_text("#pragma once\nint shared2;\n")
    elif edit == "new header":
        (csrc / "extra.cuh").write_text("int extra;\n")
    elif edit == "header removed":
        (csrc / "shared.cuh").unlink()
    elif edit == "source bytes":
        (csrc / "one.cu").write_text('#include "shared.cuh"\nint uno;\n')
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._tag(csrc / "one.cu") != before


def test_header_order_and_unrelated_files_do_not_matter(csrc):
    before = build._tag(csrc / "one.cu")
    (csrc / "notes.txt").write_text("edited\n")
    (csrc / "a_header.cuh").write_text("int a;\n")
    with_a = build._tag(csrc / "one.cu")
    assert with_a != before
    # the same set of headers gives the same tag, whatever order the
    # directory lists them in
    listed = sorted(csrc.glob("*.cuh"))
    assert [p.name for p in listed] == ["a_header.cuh", "shared.cuh"]
    assert build._tag(csrc / "one.cu") == with_a


def test_sources_list_cu_files_only(csrc):
    assert build.sources() == ["one", "two"]


def test_edited_header_rebuilds_instead_of_loading_a_stale_library(
        csrc, monkeypatch):
    compiled = []

    def fake_run(cmd, **kw):
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"library")
        compiled.append(pathlib.Path(cmd[-1]).name)

        class Done:
            returncode, stdout, stderr = 0, "", ""
        return Done()

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    first = build.build("one")
    assert build.build("one") == first and compiled == ["one.cu"]
    (csrc / "shared.cuh").write_text("#pragma once\nint shared3;\n")
    second = build.build("one")
    assert second != first and second.exists()
    assert compiled == ["one.cu", "one.cu"]
