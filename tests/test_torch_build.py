"""The build cache of the port's CUDA sources (mdilss_tpu_torch/ops/_build.py),
without nvcc: a library's path carries a hash of its source, of every header
in csrc/ and of the flags, so a changed header rebuilds every library."""
from mdilss_tpu_torch.ops import _build


def _csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "ring.cuh"\n// a\n')
    (tmp_path / "b.cu").write_text('#include "ring.cuh"\n// b\n')
    (tmp_path / "ring.cuh").write_text("// ring v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_lib_path_follows_headers(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = {n: _build._lib_path(n) for n in ("a", "b")}
    assert before == {n: _build._lib_path(n) for n in ("a", "b")}  # current: reused
    assert before["a"] != before["b"] and before["a"].name.startswith("liba-")
    (csrc / "ring.cuh").write_text("// ring v2\n")
    after = {n: _build._lib_path(n) for n in ("a", "b")}
    assert all(after[n] != before[n] for n in after)  # a changed header rebuilds both
    (csrc / "extra.cuh").write_text("// new header\n")
    assert _build._lib_path("a") != after["a"]


def test_lib_path_follows_source_and_sources_exclude_headers(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    a, b = _build._lib_path("a"), _build._lib_path("b")
    (csrc / "a.cu").write_text('#include "ring.cuh"\n// a, edited\n')
    assert _build._lib_path("a") != a and _build._lib_path("b") == b
    assert _build.all_sources() == ["a", "b"]
