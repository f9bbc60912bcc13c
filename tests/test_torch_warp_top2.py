"""The tie rule of K4's and K6's warp top-2, on the CPU.

Each kernel keeps a block's best two members as a warp: lane j pushes
members j, j + 32, j + 64, j + 96 into a local pair (`top2_push`), and five
xor shuffles combine the 32 pairs (`top2_combine`).  Here both helpers of
csrc/bigscene_kernels.cu (K6: index = lane, pad (INF, 0)) and of
csrc/scene_kernels.cu (K4: index = winner code, pad (INF, -1), masked
light members skipped) are compiled as host C++ and run lane by lane with
the same butterfly, on blocks of 128 candidates heavy with ties: values
from three or four distinct floats, INF and NaN lanes, all-INF blocks,
one finite lane at lane 0 or 127, signed zeros and -INF.  The result must
equal, bit for bit and INF slots included, the serial rule the kernels
ran before the warp design (the lanes in order, strict compares, first
lane on ties), written below in Python, and every lane of the warp must
end with the same pair.
"""

import ctypes
import zlib

import numpy as np
import pytest

from test_torch_scene_kernels import WARP_REDUCE, host_library

LB = 128

DRIVER = WARP_REDUCE + r"""
// n blocks of 128 candidates (t, index), lanes with skip[k] left out
extern "C" void host_blocks(const float* t, const int* idx,
                            const uint8_t* skip, int n, float* t_out,
                            int* i_out) {
    for (int b = 0; b < n; ++b) {
        Top2 v[32];
        for (int j = 0; j < 32; ++j) {
            v[j] = top2_empty();
            for (int k = j; k < 128; k += 32)
                if (!skip[128 * b + k])
                    top2_push(v[j], t[128 * b + k], idx[128 * b + k]);
        }
        const Top2 w = warp_reduce(v);
        t_out[2 * b] = w.t1;
        t_out[2 * b + 1] = w.t2;
        i_out[2 * b] = w.i1;
        i_out[2 * b + 1] = w.i2;
    }
}
"""

SOURCES = {"K6": ("bigscene_kernels.cu", 0), "K4": ("scene_kernels.cu", -1)}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = {}
    for name, (src, _) in SOURCES.items():
        out[name], _ = host_library(src, DRIVER,
                                    tmp_path_factory.mktemp(name))
    return out


def serial(t, idx, skip, pad):
    """The serial rule over one block: (b1, l1, b2, l2)."""
    b1 = b2 = np.float32(np.inf)
    l1 = l2 = pad
    for k in range(LB):
        if skip[k]:
            continue
        a = t[k]
        if a < b1:
            b2, l2, b1, l1 = b1, l1, a, idx[k]
        elif a < b2:
            b2, l2 = a, idx[k]
    return b1, l1, b2, l2


def _case(name, rng, n):
    """[n, 128] f32 candidates of one tie-heavy family."""
    inf = np.float32(np.inf)
    if name == "few_values":
        vals = rng.choice(np.float32([0.5, 1.25, 2.0, 3.0]), (n, LB))
        return np.where(rng.uniform(size=(n, LB)) < 0.2, inf, vals)
    if name == "mostly_inf":
        vals = rng.choice(np.float32([0.75, 0.75, 1.5]), (n, LB))
        t = np.where(rng.uniform(size=(n, LB)) < 0.95, inf, vals)
        t[::3] = inf                                    # all-INF blocks
        return t
    if name == "single_finite":
        t = np.full((n, LB), inf, np.float32)
        lanes = rng.choice([0, LB - 1, 31, 32, 96], n)
        t[np.arange(n), lanes] = rng.choice(np.float32([0.25, 2.0]), n)
        return t
    if name == "signed_zero_nan":
        return rng.choice(np.float32([-0.0, 0.0, 0.0, 1.0, np.nan, inf,
                                      -inf]), (n, LB))
    if name == "two_values_dense":
        return rng.choice(np.float32([1.0, 1.0 + 2.0 ** -23]), (n, LB))
    raise ValueError(name)


@pytest.mark.parametrize("case", ["few_values", "mostly_inf",
                                  "single_finite", "signed_zero_nan",
                                  "two_values_dense"])
@pytest.mark.parametrize("kernel", ["K6", "K4"])
def test_warp_top2_equals_serial_rule(libs, kernel, case):
    rng = np.random.default_rng(zlib.crc32(f"{kernel} {case}".encode()))
    n = 600
    t = np.ascontiguousarray(_case(case, rng, n), np.float32)
    pad = SOURCES[kernel][1]
    lanes = np.broadcast_to(np.arange(LB, dtype=np.int32), (n, LB))
    if kernel == "K6":
        idx = np.ascontiguousarray(lanes)
        skip = np.zeros((n, LB), np.uint8)
    else:
        # codes shape << 24 | member << 8 | leaf of block b: they grow
        # with the lane; a third of the lanes are masked light members
        shape = rng.integers(0, 128, (n, 1))
        b = rng.integers(0, 512, (n, 1))
        leaf = rng.integers(0, 256, (n, LB))
        idx = ((shape << 24) | ((b * LB + lanes) << 8) | leaf).astype(
            np.int32)
        skip = (rng.uniform(size=(n, LB)) < 0.33).astype(np.uint8)
    lib = libs[kernel]
    t_out = np.empty((n, 2), np.float32)
    i_out = np.empty((n, 2), np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    split0 = lib.host_split()
    lib.host_blocks(ptr(t), ptr(idx), ptr(skip), ctypes.c_int(n), ptr(t_out),
                    ptr(i_out))
    assert lib.host_split() == split0
    want_t = np.empty((n, 2), np.float32)
    want_i = np.empty((n, 2), np.int32)
    for k in range(n):
        b1, l1, b2, l2 = serial(t[k], idx[k], skip[k], pad)
        want_t[k], want_i[k] = (b1, b2), (l1, l2)
    np.testing.assert_array_equal(t_out.view(np.int32),
                                  want_t.view(np.int32))
    np.testing.assert_array_equal(i_out, want_i)
    # the family holds ties: some block's best two are equal in t
    if case not in ("single_finite", "mostly_inf"):
        assert (want_t[:, 0] == want_t[:, 1]).any()
