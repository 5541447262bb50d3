"""The shared launch path of the port's kernels (utils/kbuild.bind), on the
CPU: a stub library stands in for the one nvcc builds, so what the binder
hands to a C entry point and what it counts can be checked without a card.
"""

import ctypes
import os
import re
from collections import Counter

import pytest
import torch

import firedancer_tpu_torch.ops.blake3  # noqa: F401  (each module binds its entry points)
import firedancer_tpu_torch.ops.chacha20  # noqa: F401
import firedancer_tpu_torch.ops.gf256  # noqa: F401
import firedancer_tpu_torch.ops.keccak256  # noqa: F401
import firedancer_tpu_torch.ops.limbs  # noqa: F401
import firedancer_tpu_torch.ops.lthash  # noqa: F401
import firedancer_tpu_torch.ops.probe  # noqa: F401
import firedancer_tpu_torch.ops.sha256  # noqa: F401
import firedancer_tpu_torch.ops.sha512  # noqa: F401
import firedancer_tpu_torch.ops.sigverify  # noqa: F401
from firedancer_tpu_torch.utils import kbuild

ERRORS = {700: b"an illegal memory access was encountered"}


class StubFn:
    """A C entry point: records its calls and every assignment of its
    ctypes attributes, returns `rc`."""

    def __init__(self):
        object.__setattr__(self, "sets", Counter())
        object.__setattr__(self, "calls", [])
        object.__setattr__(self, "rc", 0)

    def __setattr__(self, key, value):
        self.sets[key] += 1
        object.__setattr__(self, key, value)

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class StubLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, sym):
        if sym == "fd_cuda_error_string":
            return lambda rc: ERRORS.get(rc, b"unknown error")
        if sym.startswith("__"):
            raise AttributeError(sym)
        return self.fns.setdefault(sym, StubFn())


@pytest.fixture
def stub(monkeypatch):
    """kbuild.load returns one stub library per name and counts its loads;
    the raw stream of device i is 0x5000 + i; LAUNCHES starts empty."""
    libs, loads = {}, Counter()

    def load(name):
        loads[name] += 1
        return libs.setdefault(name, StubLib())

    monkeypatch.setattr(kbuild, "load", load)
    monkeypatch.setattr(kbuild, "current_raw_stream", lambda i: 0x5000 + i)
    monkeypatch.setattr(kbuild, "LAUNCHES", Counter())
    made = []

    def bind(name, *a, **kw):
        k = kbuild.bind(name, *a, **kw)
        made.append((name, a[0]))
        return k

    yield libs, loads, bind
    for key in made:
        kbuild._BOUND.pop(key, None)


def test_bind_sets_argtypes_once_and_passes_device_and_stream(stub):
    libs, loads, bind = stub
    k = bind("stub_lib", "fd_stub", 2, (kbuild.I64, kbuild.I32))
    assert bind("stub_lib", "fd_stub", 2, (kbuild.I64, kbuild.I32)) is k
    assert loads["stub_lib"] == 0  # nothing is loaded before the first launch
    for i in range(3):
        k(torch.device("cuda", 3), 0x1000, None, 77 + i, 5)
    fn = libs["stub_lib"].fns["fd_stub"]
    assert fn.sets == {"argtypes": 1, "restype": 1}
    assert loads["stub_lib"] == 1
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert fn.calls[-1] == (0x1000, None, 79, 5, 3, 0x5003)
    k(torch.device("cuda"), 1, 2, 3, 4)  # no index: device 0
    assert fn.calls[-1][-2:] == (0, 0x5000)
    assert kbuild.LAUNCHES == {"stub_lib": 4}


def test_nonzero_return_code_raises_and_is_not_counted(stub):
    libs, _, bind = stub
    k = bind("stub_lib", "fd_stub_err", 1, (), counter="stub_err")
    k(torch.device("cuda", 0), 0x10)
    libs["stub_lib"].fns["fd_stub_err"].rc = 700
    with pytest.raises(RuntimeError, match=r"stub_err launch: CUDA error 700 "
                                           r"\(an illegal memory access was encountered\)"):
        k(torch.device("cuda", 0), 0x10)
    assert kbuild.LAUNCHES == {"stub_err": 1}


def test_counter_is_per_entry_point(stub):
    _, _, bind = stub
    a = bind("stub_lib", "fd_a", 1, (), counter="a")
    b = bind("stub_lib", "fd_b", 1, (), counter="b")
    with pytest.raises(ValueError, match="already bound"):
        bind("stub_lib", "fd_a", 1, (), counter="other")
    for _ in range(2):
        a(torch.device("cuda", 0), 1)
    b(torch.device("cuda", 0), 1)
    assert kbuild.LAUNCHES == {"a": 2, "b": 1}


def test_unload_rebinds_at_the_next_launch(stub):
    libs, loads, bind = stub
    k = bind("stub_lib", "fd_stub", 0, ())
    k(torch.device("cuda", 0))
    kbuild.unload("stub_lib")
    libs.clear()
    k(torch.device("cuda", 0))
    assert loads["stub_lib"] == 2
    assert libs["stub_lib"].fns["fd_stub"].sets == {"argtypes": 1, "restype": 1}


_CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
          "int64_t": ctypes.c_int64, "int": ctypes.c_int,
          "const uint8_t*": ctypes.c_void_p, "uint8_t*": ctypes.c_void_p,
          "uint64_t": ctypes.c_uint64}


def _c_prototypes() -> dict:
    """{symbol: [ctypes type of each parameter]} of every FD_EXPORT int
    entry point in csrc/*.cu."""
    out = {}
    for f in os.listdir(kbuild.CSRC_DIR):
        if not f.endswith(".cu"):
            continue
        with open(os.path.join(kbuild.CSRC_DIR, f)) as fh:
            src = fh.read()
        for sym, params in re.findall(r"FD_EXPORT int (fd_\w+)\(([^)]*)\)", src):
            types = []
            for p in params.split(","):
                p = " ".join(p.split())
                ty = re.sub(r"\s*\w+$", "", p).replace(" *", "*")
                types.append(_CTYPE[ty])
            out[(f[:-3], sym)] = types
    return out


def test_every_bound_entry_point_matches_its_c_prototype():
    """Every C entry point is bound through kbuild.bind with its C
    argument types, but the native shredder's parity call, which C reaches
    through a function pointer of runtime/shred_native.ENCODE_FN's type
    (that module folds its launches into the count)."""
    from firedancer_tpu_torch.runtime import shred_native

    protos = _c_prototypes()
    bound = dict(kbuild._BOUND)
    by_pointer = {("gf256_apply", "fd_gf256_encode_host"): shred_native.ENCODE_FN}
    assert bound, "the ops modules bind their entry points at import"
    assert set(bound) | set(by_pointer) == set(protos), "every C entry point has one binding"
    assert not set(bound) & set(by_pointer)
    for key, k in bound.items():
        assert k.argtypes == protos[key], key
    for key, fn in by_pointer.items():
        assert list(fn._argtypes_) == protos[key] and fn._restype_ is ctypes.c_int, key
