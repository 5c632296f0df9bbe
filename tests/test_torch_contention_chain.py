"""The contention kernel's sums and its wrapper's inputs, on the CPU.

``csrc/contention_eta.cu`` takes a compensated sum in three warps: warp 0
runs the f chain, t_i = f_{i-1} + x_i, keeping f once a ring of
``CHAIN_RING`` lanes; warp 2 walks each ring again from its checkpoint (the
same adds, so the same t_i) and forms Neumaier's error term

    e_i = |f_{i-1}| >= |x_i| ? (f_{i-1} - t_i) + x_i : (x_i - t_i) + f_{i-1}

and warp 1 adds the e_i into c left to right, ``CHAIN_CHUNK`` lanes at a
time; the result is f + c where c is finite and non-zero.
``split_chain_sum`` below repeats that order step for step in Python
floats, and must give the bits of the builtin ``sum()`` (CPython 3.12's
compensated sum) and of the plain version's ``_serial_sum`` on any list:
cancellations, mixed signs, infinities and NaNs included. The plain chain
(every f32 call, and ``compensated=False``) is one left-to-right add a
lane.

The wrapper takes its columns as lists, numpy arrays or CPU tensors; the
plain path must give the same results from each, and the kernel's
shared-memory limit (``resident_max``) must follow its layout.
"""
import math
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import contention_eta as ce  # noqa: E402
from repro_torch.runtime.contention import DeviceModel  # noqa: E402

needs_compensated_sum = pytest.mark.skipif(
    not ce.SUM_IS_COMPENSATED,
    reason="builtin sum() compensates from CPython 3.12 on")


def split_chain_sum(vals, ring=ce.CHAIN_RING, chunk=ce.CHAIN_CHUNK,
                    scalar=float):
    """The kernel's compensated sum in its order: warp 0's f chain with a
    checkpoint a ring, warp 2's rings walked again from their checkpoints
    into e_i, warp 1's c chain over them a chunk at a time."""
    xs = [scalar(v) for v in vals]
    zero = scalar(0.0)
    if not xs:
        return zero
    ck, f = [], zero
    for i, x in enumerate(xs):                      # warp 0
        f = f + x
        if (i + 1) % ring == 0:
            ck.append(f)
    es = []
    for g, r0 in enumerate(range(0, len(xs), ring)):  # warp 2, a ring a lane
        fr = ck[g - 1] if g else zero
        for x in xs[r0:r0 + ring]:
            t = fr + x
            a, b = (fr, x) if abs(fr) >= abs(x) else (x, fr)
            es.append((a - t) + b)
            fr = t
    c = zero
    for base in range(0, len(es), chunk):           # warp 1
        for e in es[base:base + chunk]:
            c = c + e
    return f + c if c != 0 and math.isfinite(c) else f


def plain_chain_sum(vals, scalar=float):
    f = scalar(0.0)
    for v in vals:
        f = f + scalar(v)
    return f


def same_bits(a, b):
    a, b = float(a), float(b)
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return struct.pack("<d", a) == struct.pack("<d", b)


FLOATS = st.floats(allow_nan=True, allow_infinity=True)
FINITE = st.floats(min_value=-1e300, max_value=1e300)
CANCELLING = st.lists(st.tuples(FINITE, FINITE), max_size=40).map(
    lambda ps: [v for a, b in ps for v in (a, b, -a)])

CASES = [
    [1.0, 1e100, 1.0, -1e100],
    [0.1] * 10,
    [1e16, 1.0, -1e16, 1.0],
    [-0.0],
    [-0.0, -0.0],
    [float("inf")],
    [float("inf"), 1.0, -1.0],
    [1.0, float("inf"), float("-inf")],
    [float("nan"), 1.0],
    [1e308, 1e308, -1e308],
    [5e-324, -5e-324, 1e-300],
    [3.0, -1e100, 1e100, 2.0] * 70,
]


@needs_compensated_sum
@pytest.mark.parametrize("ring", [1, 3, ce.CHAIN_RING])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_split_chain_matches_builtin_sum_on_edge_cases(case, ring):
    vals = CASES[case]
    got = split_chain_sum(vals, ring)
    assert same_bits(got, sum(vals))
    assert same_bits(got, ce._serial_sum(vals, True, float))


@needs_compensated_sum
@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.one_of(st.lists(FLOATS, max_size=80),
                 st.lists(FINITE, min_size=200, max_size=700),
                 CANCELLING),
       st.sampled_from([1, 7, ce.CHAIN_RING, 32]))
def test_split_chain_matches_builtin_sum(vals, ring):
    got = split_chain_sum(vals, ring)
    assert same_bits(got, sum(vals))
    assert same_bits(got, ce._serial_sum(vals, True, float))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(FLOATS, max_size=300))
def test_plain_chain_matches_serial_sum(vals):
    assert same_bits(plain_chain_sum(vals), ce._serial_sum(vals, False, float))
    f32 = [float(np.float32(v)) for v in vals if abs(v) < 3e38 or
           not math.isfinite(v)]
    with np.errstate(over="ignore", invalid="ignore"):
        assert same_bits(plain_chain_sum(f32, np.float32),
                         ce._serial_sum(f32, False, np.float32))


def test_resident_limit_follows_the_layout():
    """Five columns of m (rounded up to 32) and 128 bytes ahead of them fit
    in a block's 232,448 bytes on the H100."""
    for dtype, limit in ((torch.float64, 5792), (torch.float32, 11616)):
        elt = 8 if dtype == torch.float64 else 4
        assert ce.resident_max(dtype) == limit
        used = ce.HEAD + ce.COLUMNS * ce.col_stride(limit) * elt
        assert used <= ce.H100_SMEM_OPTIN
        assert ce.HEAD + ce.COLUMNS * ce.col_stride(limit + 1) * elt \
            > ce.H100_SMEM_OPTIN
        assert ce.contention_instance(limit, dtype) == "resident"
        assert ce.contention_instance(limit + 1, dtype) == "tiled"
        assert ce.contention_instance(12289, dtype) == "tiled"
    assert [ce.col_stride(m) for m in (1, 32, 33, 4096)] == [32, 32, 64, 4096]
    assert ce.resident_max(torch.float64, 48 * 1024) == 1216


def _cols(m, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.2, 4.0, m), rng.uniform(5.0, 40.0, m),
            rng.uniform(0.05, 0.9, m), rng.uniform(0.1, 8.0, m)]


@pytest.mark.parametrize("m", [1, 16, 300])
def test_plain_path_same_from_lists_arrays_and_tensors(m):
    dm = DeviceModel(n_units=40.0, bubble=0.17, l2_pressure=0.013)
    arrays = _cols(m, seed=m)
    forms = {"lists": [a.tolist() for a in arrays], "arrays": arrays,
             "tensors": [torch.from_numpy(a) for a in arrays],
             "f32_arrays": [a.astype(np.float32) for a in arrays]}
    base = forms["lists"]
    for comp in (True, False):
        want = ce.rates(dm, *base[:3], device="cpu", compensated=comp)
        want_f = ce.fused(dm, 2.5, *base, device="cpu", compensated=comp)
        for name in ("arrays", "tensors"):
            cols = forms[name]
            assert ce.rates(dm, *cols[:3], device="cpu",
                            compensated=comp) == want, name
            got = ce.fused(dm, 2.5, *cols, device="cpu", compensated=comp)
            assert all(np.array_equal(a, b) for a, b in zip(got, want_f))
    want32 = ce.fused_f32(dm, 2.5, *base, device="cpu")
    for name in ("arrays", "tensors", "f32_arrays"):
        got = ce.fused_f32(dm, 2.5, *forms[name], device="cpu")
        assert all(a.dtype == np.float32 and np.array_equal(a, b)
                   for a, b in zip(got, want32)), name


def test_lane_columns_rounds_as_the_jax_module_and_fills_rem():
    u, ns, mf, rem = _cols(37)
    x = ce.lane_columns(u.tolist(), ns, torch.from_numpy(mf), None,
                        torch.float32)
    want = np.stack([u, ns, mf, np.zeros(37)]).astype(np.float32)
    assert x.dtype == torch.float32 and np.array_equal(x.numpy(), want)
    buf = np.full((4, 64), np.nan)
    y = ce.lane_columns(u, ns, mf, rem, torch.float64, out=buf)
    assert y.shape == (4, 37) and np.shares_memory(y.numpy(), buf)
    assert np.array_equal(y.numpy(), np.stack([u, ns, mf, rem]))
    assert np.isnan(buf[:, 37:]).all()
