"""The kernel build's library names: an edited source or shared header never
loads a stale build. Needs no card and no nvcc (nothing is compiled)."""

import shutil

from vision_mtl_tpu_torch.kernels import _build


def test_library_path_covers_sources_and_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = ("fused_gate", "gate_train", "confmat")
    before = {name: _build.library_path(name) for name in names}
    assert before == {name: _build.library_path(name) for name in names}  # stable

    header = csrc / "gate_tile.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after_header = {name: _build.library_path(name) for name in names}
    assert all(after_header[name] != before[name] for name in names)

    source = csrc / "confmat.cu"
    source.write_bytes(source.read_bytes() + b"\n// edited\n")
    after_source = {name: _build.library_path(name) for name in names}
    assert after_source["confmat"] != after_header["confmat"]
    assert after_source["fused_gate"] == after_header["fused_gate"]
    assert after_source["gate_train"] == after_header["gate_train"]
