"""The port's native tcache (tango/tcache_native.py over
firedancer_tpu_torch/native/fd_tcache.cpp, built by utils/hostbuild.py)
against the port's Python TCache and the JAX package's NativeTCache: the
same duplicate verdicts over seeded streams, the null tag, eviction
oldest first; the dedup stage takes it; and a compiler
that fails raises, with nothing to fall back to."""

import numpy as np
import pytest

from firedancer_tpu.tango import tcache_native as jnat
from firedancer_tpu_torch.runtime.dedup import DedupStage
from firedancer_tpu_torch.tango import tcache_native as tnat
from firedancer_tpu_torch.tango.rings import TCache
from firedancer_tpu_torch.utils import hostbuild


@pytest.mark.parametrize("depth,hi", [(64, 200), (4, 9), (1024, 5000)])
def test_native_equals_python_and_jax(depth, hi):
    py, cc, jx = TCache(depth), tnat.NativeTCache(depth), jnat.NativeTCache(depth)
    try:
        rng = np.random.default_rng(depth)
        # heavy duplication drives the eviction and re-probe paths
        for t in rng.integers(0, hi, 5000, dtype=np.uint64):
            got = cc.insert(int(t))
            assert got == py.insert(int(t)) == jx.insert(int(t))
        for t in range(hi + 50):
            assert cc.query(t) == jx.query(t) == (t != 0 and t in py.map)
    finally:
        cc.close()
        jx.close()


def test_null_tag_never_dedups_and_tags_wrap_to_64_bits():
    cc = tnat.NativeTCache(8)
    try:
        assert cc.insert(0) is False and cc.insert(0) is False and cc.query(0) is False
        assert cc.insert(2**64 + 5) is False
        assert cc.insert(5) is True
    finally:
        cc.close()


def test_eviction_oldest_first():
    cc = tnat.NativeTCache(4)
    try:
        for t in (1, 2, 3, 4):
            assert cc.insert(t) is False
        assert cc.insert(5) is False  # evicts 1
        assert not cc.query(1)
        assert all(cc.query(t) for t in (2, 3, 4, 5))
    finally:
        cc.close()


def test_dedup_stage_takes_the_native_tcache():
    assert isinstance(DedupStage("dedup").tcache, tnat.NativeTCache)


def test_sources_and_build_stay_in_the_port():
    """The library builds from the port's own source into the port's build
    folder: never from, or into, the repo's native/."""
    path = hostbuild.so_path("fd_tcache")
    assert hostbuild.source("fd_tcache").startswith(hostbuild.NATIVE_DIR)
    assert hostbuild.NATIVE_DIR.endswith("firedancer_tpu_torch/native")
    assert path.startswith(hostbuild.BUILD_ROOT) and "torch_native" in path
    assert hostbuild.build("fd_tcache") == path


def test_a_failing_compiler_raises(monkeypatch, tmp_path):
    """A compiler that fails (or is missing) raises HostBuildError: no
    fallback to the Python TCache, no switch.  Its libraries land in a
    folder of their own (the compiler is in the hash), so a built library
    of another compiler does not hide the failure."""
    monkeypatch.setattr(hostbuild, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(hostbuild, "CXX", "false")
    with pytest.raises(hostbuild.HostBuildError, match="false failed for fd_tcache.cpp"):
        tnat.NativeTCache(8)
    with pytest.raises(hostbuild.HostBuildError):
        DedupStage("dedup")
    monkeypatch.setattr(hostbuild, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(hostbuild.HostBuildError, match="could not run"):
        tnat.NativeTCache(8)
    assert not list(tmp_path.rglob("*.so"))
