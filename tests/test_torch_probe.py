"""probe_conv's split over a block's warps (csrc/probe.cu), read from the
source: each warp's contiguous group of output rows, the limbs it loads
for them, and each row's 32-bit products, modelled in numpy and held to
the plain version and to Python ints with the int32 extremes (wrapping
mod 2^32).  Inputs are made with numpy from a seed."""
import os
import re

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.ops import probe as tprobe
from firedancer_tpu_torch.utils import kbuild

with open(os.path.join(kbuild.CSRC_DIR, "probe.cu")) as _f:
    _SRC = _f.read()
NLIMB = int(re.search(r"#define PROBE_NLIMB (\d+)", _SRC).group(1))
GROUPS = int(re.search(r"#define PROBE_GROUPS (\d+)", _SRC).group(1))
EDGES = [int(v) for v in re.search(r"edge\[PROBE_GROUPS \+ 1\] = \{([^}]*)\}", _SRC)
         .group(1).split(",")]
ROWS = 2 * NLIMB - 1
EXTREMES = (2**31 - 1, -2**31, -2**31 + 1)


def _products(k):
    return min(k + 1, ROWS - k)


def conv_model(a: np.ndarray, b: np.ndarray, edges=EDGES) -> np.ndarray:
    """The kernel's arithmetic: warp w loads limbs [lo, hi] of a and b
    (the ones its rows [edges[w], edges[w + 1]) read) and sums each row's
    products in uint32.  edges (0, ROWS) is the one-lane-a-thread form."""
    out = np.full((ROWS, a.shape[1]), 0xDEAD, dtype=np.uint32)
    for w in range(len(edges) - 1):
        r0, r1 = edges[w], edges[w + 1]
        lo, hi = max(r0 - (NLIMB - 1), 0), min(r1 - 1, NLIMB - 1)
        av = {i: a[i].astype(np.uint32) for i in range(lo, hi + 1)}
        bv = {i: b[i].astype(np.uint32) for i in range(lo, hi + 1)}
        for k in range(r0, r1):
            acc = np.zeros(a.shape[1], dtype=np.uint32)
            for i in range(NLIMB):
                if 0 <= k - i < NLIMB:
                    acc += av[i] * bv[k - i]
            out[k] = acc
    return out.view(np.int32)


def test_probe_conv_row_groups_cover_every_row_once_and_balance():
    """Every one of the 39 rows is in exactly one warp's group, the groups
    are contiguous and in order, and no group has more than 105 of the 400
    products (the best four contiguous groups can do; 100 each is the mean)."""
    assert len(EDGES) == GROUPS + 1 and EDGES[0] == 0 and EDGES[-1] == ROWS
    owner = [w for w in range(GROUPS) for _ in range(EDGES[w], EDGES[w + 1])]
    assert owner == sorted(owner) and len(owner) == ROWS
    counts = [sum(_products(k) for k in range(EDGES[w], EDGES[w + 1])) for w in range(GROUPS)]
    assert sum(counts) == NLIMB * NLIMB == 400
    assert max(counts) <= 105 and min(counts) >= 91, counts


@pytest.mark.parametrize("bsz", [1, 33, 512])
def test_probe_conv_model_equals_plain_and_python_ints_at_int32_extremes(bsz):
    rng = np.random.default_rng(300 + bsz)
    a, b = rng.integers(-2**31, 2**31, (2, NLIMB, bsz), dtype=np.int64)
    a[:, 0], b[:, 0] = EXTREMES[0], EXTREMES[1]
    if bsz > 1:
        a[:, 1], b[:, 1] = EXTREMES[1], EXTREMES[1]
        a[::2, -1], b[1::2, -1] = EXTREMES[2], EXTREMES[0]
    a32, b32 = a.astype(np.int32), b.astype(np.int32)
    got = conv_model(a32, b32)
    plain = tprobe.probe_conv(torch.from_numpy(a32), torch.from_numpy(b32)).numpy()
    assert np.array_equal(got, plain)
    for lane in {0, bsz - 1}:
        want = [sum(int(a[i, lane]) * int(b[k - i, lane])
                    for i in range(max(0, k - NLIMB + 1), min(k, NLIMB - 1) + 1))
                for k in range(ROWS)]
        assert [(v + 2**31) % 2**32 - 2**31 for v in want] == got[:, lane].tolist()


@pytest.mark.parametrize("bsz", [1, 33])
def test_probe_conv_one_lane_form_model_equals_plain_at_int32_extremes(bsz):
    """The form past B = 128 x SMs (probe_conv_lane_kernel): one thread
    loads all 40 limbs of its lane and sums all 39 rows, equal to the plain
    version with the int32 extremes on the first and last lanes."""
    assert "probe_conv_rows<0, 2 * PROBE_NLIMB - 1>" in _SRC
    rng = np.random.default_rng(400 + bsz)
    a, b = rng.integers(-2**31, 2**31, (2, NLIMB, bsz), dtype=np.int64)
    a[:, 0], b[:, -1] = EXTREMES[1], EXTREMES[0]
    a32, b32 = a.astype(np.int32), b.astype(np.int32)
    plain = tprobe.probe_conv(torch.from_numpy(a32), torch.from_numpy(b32)).numpy()
    assert np.array_equal(conv_model(a32, b32, edges=(0, ROWS)), plain)
