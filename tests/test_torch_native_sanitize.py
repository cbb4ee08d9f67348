"""Sanitizer gate for the port's native sampler library (the port of
``tests/test_native_sanitize.py``): ``native.run_sanitizer_check`` builds
the port's ``native/sampler.cpp`` with the port's standalone driver
``native/sanitize_check.cpp`` under ASAN+UBSAN and under TSAN (the std::thread
pool build, ``-DSAMPLER_STD_THREADS``) and runs it — the BFS, batch
assembly over five generations of shared stamped scratch, the PinSAGE
frontier and the walk step. Each case skips, on the JAX test's condition,
where ``g++`` cannot link that sanitizer's runtime (decided when the test
runs, not when the module is collected)."""
import subprocess

import pytest

from laplace_gnn_recommendation_tpu_torch import native


def _has_sanitizer(flag: str) -> bool:
    """g++ present and able to link the sanitizer runtime."""
    probe = ("echo 'int main(){return 0;}' | "
             f"g++ -x c++ - -fsanitize={flag} -fopenmp -o /dev/null")
    try:
        return subprocess.run(probe, shell=True, capture_output=True, timeout=120).returncode == 0
    except Exception:
        return False


def test_native_asan_ubsan_clean():
    if not _has_sanitizer("address"):
        pytest.skip("no ASAN runtime")
    ok, out = native.run_sanitizer_check("asan")
    assert ok, out
    assert "sanitize_check ok" in out


def test_native_tsan_clean():
    if not _has_sanitizer("thread"):
        pytest.skip("no TSAN runtime")
    ok, out = native.run_sanitizer_check("tsan")
    assert ok, out
    assert "sanitize_check ok" in out


def test_driver_is_the_ports_own():
    """The driver builds against the port's copy of the library source, and a
    broken mode name is refused before anything is built."""
    import os

    assert os.path.dirname(native.SOURCE) == os.path.dirname(native.__file__)
    assert os.path.exists(os.path.join(os.path.dirname(native.__file__), "sanitize_check.cpp"))
    with pytest.raises(KeyError):
        native.run_sanitizer_check("msan")
