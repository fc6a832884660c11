"""The banded graph format and its SpMM, cna_tpu_torch against cna_tpu on
the CPU.

The same scipy graphs (made with numpy from a seed) are packed by both
packages and the packed fields compared array for array; the same packed
graph (carried over with ``banded_graph_from_numpy``) is multiplied by both.
On the CPU the port's ``banded_spmm`` takes the kernel's plain version
(``banded_spmm_plain``); the CUDA kernel itself is held to the plain
version on the card (``tests/test_torch_card.py``, ``chip_smoke.py``).

The TPU package runs here as its own tests run it: the Pallas kernel in
interpret mode, which accumulates in float32 whatever the state's type
(so it is held at the float32 tolerance of ``tests/test_spmm_pallas.py``),
and its XLA twin ``_banded_spmm_xla`` / the non-interpret ``banded_spmm``,
which keep float64 (held at rtol 1e-12).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import cna_tpu_torch as ct
from cna_tpu.graph.ell import from_scipy as tpu_from_scipy
from cna_tpu.ops import spmm_pallas as tpu_banded
from cna_tpu_torch.graph.ell import from_scipy
from cna_tpu_torch.ops import spmm_banded as sb
from cna_tpu_torch.ops.spmm import graph_spmm

from .torch_parity import torch_cpu_x64  # noqa: F401

F64_RTOL = 1e-12
# the interpreted Pallas kernel accumulates in float32
F32_RTOL, F32_ATOL = 2e-5, 1e-5

FIELDS = ("lidx", "weights", "slab_starts", "spill_indices", "spill_weights",
          "overflow_rows", "overflow_cols", "overflow_weights", "colsums_raw")
GEOMETRY = ("n_rows_true", "row_tile", "slab_rows")


def banded_random_graph(n, k, band, seed=0, long_range_frac=0.05):
    """Symmetric weighted graph with mostly-local neighbours (the
    generator of ``tests/test_spmm_pallas.py``)."""
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for i in range(n):
        local = i + rng.randint(-band, band + 1, size=k)
        far = rng.randint(0, n, size=max(1, int(k * long_range_frac)))
        nbrs = np.unique(np.clip(np.concatenate([local, far]), 0, n - 1))
        nbrs = nbrs[nbrs != i]
        rows.extend([i] * len(nbrs))
        cols.extend(nbrs)
    w = rng.rand(len(rows)) * 0.9 + 0.1
    a = sp.csr_matrix((w, (rows, cols)), shape=(n, n))
    return (a + a.T).tocsr()


def hub_graph(n, seed):
    """A banded graph plus a few hub rows, so that the ELL overflows, the
    spill ELL fills and the COO tail holds edges of both kinds."""
    a = banded_random_graph(n, 6, 20, seed=seed).tolil()
    rng = np.random.RandomState(seed + 1)
    for hub in (3, n // 2):
        cols = rng.choice(n, 90, replace=False)
        cols = cols[cols != hub]
        a[hub, cols] = 0.5
        a[cols, hub] = 0.5
    return a.tocsr()


def fields_of(graph):
    """(arrays by name, geometry) of either package's BandedGraph."""
    return ({f: np.asarray(getattr(graph, f)) for f in FIELDS},
            {g: getattr(graph, g) for g in GEOMETRY})


def assert_same_pack(tpu_graph, parts):
    arrays, geometry = fields_of(tpu_graph)
    for name in FIELDS:
        got = np.asarray(parts[name])
        assert got.shape == arrays[name].shape, name
        assert got.dtype == arrays[name].dtype, name
        np.testing.assert_array_equal(got, arrays[name], err_msg=name)
    for name in GEOMETRY:
        assert parts[name] == geometry[name], name


def carried_over(tpu_graph):
    arrays, geometry = fields_of(tpu_graph)
    return ct.ut.banded_graph_from_numpy(**arrays, **geometry)


CASES = {
    "banded_600": dict(n=600, row_tile=128, window=128, band=60),
    "banded_1024": dict(n=1024, row_tile=128, window=128, band=60),
    "ragged_333": dict(n=333, row_tile=64, window=16, band=10),
    "below_slab": dict(n=300, row_tile=128, window=128, band=30),
}


def _case_graph(case):
    c = CASES[case]
    return banded_random_graph(c["n"], 8, c["band"], seed=len(case)), c


@pytest.mark.parametrize("case", list(CASES))
def test_pack_from_scipy_matches(case):
    a, c = _case_graph(case)
    kw = dict(row_tile=c["row_tile"], window=c["window"])
    ref = tpu_banded.banded_from_scipy(a, **kw)
    got = sb.banded_from_scipy(a, **kw)
    assert_same_pack(ref, {**{f: getattr(got, f).numpy() for f in FIELDS},
                           **{g: getattr(got, g) for g in GEOMETRY}})
    assert got.band_fraction() == ref.band_fraction()
    assert got.n_rows == ref.n_rows == c["n"]
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.colsums(0.5).numpy(),
                                  np.asarray(ref.colsums(0.5)))


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_from_ell_matches_with_spill_and_coo_tail(seed):
    a = hub_graph(400, seed)
    ref_ell = tpu_from_scipy(a)
    ell = from_scipy(a)
    assert ell.n_overflow > 0
    ref = tpu_banded.banded_from_ell(ref_ell, row_tile=64, window=16)
    parts = sb._banded_pack(
        ell.indices.numpy(), ell.weights.numpy(), ell.overflow_rows.numpy(),
        ell.overflow_cols.numpy(), ell.overflow_weights.numpy(),
        ell.colsums_raw.numpy(), 64, 16)
    assert_same_pack(ref, parts)
    assert parts["spill_indices"].shape[1] > 0
    assert len(parts["overflow_rows"]) > ell.n_overflow  # the spill's residue
    got = sb.banded_from_ell(ell, row_tile=64, window=16)
    assert got.band_fraction() == ref.band_fraction()
    assert 0 < got.band_fraction() < 1
    # float32 repack of a float64 graph, as the TPU package's dtype=
    ref32 = tpu_banded.banded_from_ell(ref_ell, 64, 16, dtype=np.float32)
    got32 = sb.banded_from_ell(ell, 64, 16, dtype=torch.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_array_equal(got32.weights.numpy(),
                                  np.asarray(ref32.weights))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("s", [1, 12, 40])
def test_spmm_matches_tpu_package_and_scipy(case, s):
    a, c = _case_graph(case)
    ref = tpu_banded.banded_from_scipy(a, row_tile=c["row_tile"],
                                       window=c["window"])
    graph = carried_over(ref)
    x = np.random.RandomState(1).rand(c["n"], s)
    got = sb.banded_spmm(graph, torch.as_tensor(x)).numpy()
    assert got.shape == (c["n"], s)
    np.testing.assert_allclose(got, a @ x, rtol=F64_RTOL, atol=1e-13)
    # the XLA twin (what banded_spmm runs off the TPU): float64 throughout
    np.testing.assert_allclose(
        got, np.asarray(tpu_banded.banded_spmm(ref, x)), rtol=F64_RTOL,
        atol=1e-13)
    # the Pallas kernel, interpreted: float32 accumulation
    np.testing.assert_allclose(
        got, np.asarray(tpu_banded.banded_spmm(ref, x, interpret=True)),
        rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("case", ["banded_600", "ragged_333", "below_slab"])
def test_plain_inband_product_matches_xla_twin(case):
    """The in-band product alone, a row for every padded row, against the
    TPU package's twin on its padded state."""
    a, c = _case_graph(case)
    ref = tpu_banded.banded_from_scipy(a, row_tile=c["row_tile"],
                                       window=c["window"])
    graph = carried_over(ref)
    n, s = c["n"], 9
    x = np.random.RandomState(2).rand(n, s)
    got = sb.banded_inband(graph, torch.as_tensor(x)).numpy()
    n_pad = ref.lidx.shape[0]
    assert got.shape == (n_pad, s)
    x_pad = np.zeros((max(n_pad, ref.slab_rows), s))
    x_pad[:n] = x
    want = np.asarray(tpu_banded._banded_spmm_xla(
        ref.lidx, ref.weights, ref.slab_starts, jnp.asarray(x_pad),
        ref.row_tile, ref.slab_rows))
    np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=1e-13)
    assert not got[n:].any()  # padding rows hold no edge


def test_float32_graph_matches_interpreted_kernel():
    a = banded_random_graph(600, 8, 60)
    ref = tpu_banded.banded_from_scipy(a, row_tile=128, window=128,
                                       dtype=np.float32)
    graph = carried_over(ref)
    assert graph.dtype == torch.float32
    x = np.random.RandomState(3).rand(600, 12).astype(np.float32)
    got = sb.banded_spmm(graph, torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(tpu_banded.banded_spmm(ref, x, interpret=True)),
        rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(got, a @ x.astype(np.float64), rtol=F32_RTOL,
                               atol=F32_ATOL)


def test_fully_out_of_band_edges_spill():
    """A purely random graph: nothing lies in a +-16 band, every edge goes
    through the spill ELL and the COO tail."""
    n = 300
    rng = np.random.RandomState(4)
    rows = np.repeat(np.arange(n), 4)
    cols = rng.randint(0, n, 4 * n)
    keep = rows != cols
    a = sp.csr_matrix((rng.rand(keep.sum()), (rows[keep], cols[keep])),
                      shape=(n, n))
    a = (a + a.T).tocsr()
    ref = tpu_banded.banded_from_ell(tpu_from_scipy(a), row_tile=64,
                                     window=16)
    ell = from_scipy(a)
    got = sb.banded_from_ell(ell, row_tile=64, window=16)
    assert got.band_fraction() == ref.band_fraction() < 0.5
    x = rng.rand(n, 8)
    y = sb.banded_spmm(got, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, graph_spmm(ell, torch.as_tensor(x)).numpy(),
                               rtol=F64_RTOL, atol=1e-13)
    np.testing.assert_allclose(y, a @ x, rtol=F64_RTOL, atol=1e-13)


def test_no_edges_in_band_width_zero():
    """K = 0 and a spill of width 0: an all-zero product of the right
    shape."""
    g = sb.banded_from_arrays(
        np.zeros((128, 0), np.int32), np.zeros((128, 0)),
        np.zeros(2, np.int32), np.zeros((100, 0), np.int32),
        np.zeros((100, 0)), np.zeros(0, np.int32), np.zeros(0, np.int32),
        np.zeros(0), np.zeros(100), 100, 64, 96)
    y = sb.banded_spmm(g, torch.ones((100, 3), dtype=torch.float64))
    assert y.shape == (100, 3) and not y.any()
    assert g.band_fraction() == 0.0


def test_diffusion_step_banded_matches_reference_formula():
    n, s = 512, 10
    a = banded_random_graph(n, 6, 40, seed=3)
    ref = tpu_banded.banded_from_scipy(a, row_tile=128, window=64)
    graph = sb.banded_from_scipy(a, row_tile=128, window=64)
    x = np.random.RandomState(2).rand(n, s)
    colsums = graph.colsums(1.0)
    got = sb.diffusion_step_banded(torch.as_tensor(x), graph, colsums,
                                   1.0).numpy()
    t = x / colsums.numpy()[:, None]
    np.testing.assert_allclose(got, a @ t + t, rtol=F64_RTOL)
    np.testing.assert_allclose(
        got, np.asarray(tpu_banded.diffusion_step_banded(
            jnp.asarray(x), ref, ref.colsums(1.0), 1.0)), rtol=F64_RTOL)
    # the format dispatch of ops.spmm reaches the same step
    from cna_tpu_torch.ops import spmm

    np.testing.assert_array_equal(
        spmm.diffusion_step(torch.as_tensor(x), graph, colsums, 1.0).numpy(),
        got)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    a = banded_random_graph(200, 4, 10)
    g = sb.banded_from_scipy(a, row_tile=64, window=16)
    x = torch.rand(200, 3, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or float64"):
        sb.banded_inband(g, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        sb.banded_inband(g, torch.rand(3, 200, dtype=torch.float64).T)
    with pytest.raises(ValueError, match="multiple of"):
        sb._check(g.lidx[:100], g.weights[:100], g.slab_starts, x, 64, 96)
    with pytest.raises(ValueError, match="one start per row tile"):
        sb._check(g.lidx, g.weights, g.slab_starts[:2], x, 64, 96)


def test_column_chunks_fit_the_shared_memory_or_raise():
    """Shapes that the staged kernel had to cut into column chunks, or to
    refuse because one column of the slab outgrew a thread block's shared
    memory (S = 200 in float64; a slab of 20,000 rows; a window of 40,000):
    the kernel stages no slab any more, so each of them is simply taken.
    Their compacted slots give the packed graph's in-band product, and the
    thread's vector width is all the geometry that is left."""
    limit = 232448  # what an H100 thread block may opt into
    shapes = [  # n, row_tile, window, S, dtype
        (3_000, 256, 512, 200, np.float64),  # 1,280 x 200 x 8 B > limit
        (21_000, 256, 9_872, 8, np.float64),  # slab 20,000: no chunk fitted
        (2_000, 256, 40_000, 50, np.float64),  # raised "232448 bytes"
        (3_000, 256, 512, 50, np.float32),  # took 2 chunks of 25 columns
    ]
    for n, tile, window, s, dtype in shapes:
        a = banded_random_graph(n, 4, 40, seed=n % 7)
        graph = sb.banded_from_scipy(a, row_tile=tile, window=window,
                                     dtype=dtype)
        item = np.dtype(dtype).itemsize
        assert graph.slab_rows == tile + 2 * window
        assert graph.slab_rows * s * item > limit
        _assert_compact_is_the_packed_rows(graph)
        x = torch.as_tensor(np.random.RandomState(n).rand(n, s)
                            .astype(dtype))
        want = sb.banded_spmm_plain(graph.lidx, graph.weights,
                                    graph.slab_starts, x, tile,
                                    graph.slab_rows)
        got = compact_inband_plain(graph.compact, graph.slab_starts, x, tile)
        rtol = 1e-12 if dtype == np.float64 else 1e-6
        assert got.shape == want.shape == (graph.lidx.shape[0], s)
        assert float(want.abs().max()) > 0
        assert float((got - want).abs().max()) \
            <= rtol * float(want.abs().max())
        # and the wrapper's CPU route takes them too
        np.testing.assert_array_equal(sb.banded_inband(graph, x).numpy(),
                                      want.numpy())
        assert sb.gather_vec(s, item, 0, 0) == (4 if item == 4 and s % 4 == 0
                                                else 2)


# --- the compacted slots the CUDA kernel reads ------------------------------


def compact_inband_plain(compact, slab_starts, x, row_tile):
    """The in-band product read from the compacted slots, in plain
    PyTorch: what the CUDA kernel computes from the same arrays.  (N_pad, S)
    out, slab rows beyond ``x`` read as zeros."""
    n_pad = compact.row_nnz.shape[0]
    n_x, s = x.shape
    ptr = compact.row_ptr.long()
    rows = torch.repeat_interleave(
        torch.arange(n_pad, device=x.device), ptr[1:] - ptr[:-1])
    starts = slab_starts.long()[torch.div(rows, row_tile,
                                          rounding_mode="floor")]
    gidx = starts + compact.lidx.long()
    inside = gidx < n_x
    terms = (compact.weights * inside)[:, None] * x[gidx * inside]
    return x.new_zeros((n_pad, s)).index_add_(0, rows, terms)


def _assert_compact_is_the_packed_rows(graph):
    """Row by row: the non-zero slots of the packed row, in their order,
    then zero slots up to a multiple of SLOT_GROUP."""
    c = graph.compact
    lidx, w = graph.lidx.numpy(), graph.weights.numpy()
    ptr = c.row_ptr.numpy()
    assert c.row_ptr.dtype == c.lidx.dtype == c.row_nnz.dtype == torch.int32
    assert c.weights.dtype == graph.weights.dtype
    assert ptr[0] == 0 and ptr[-1] == len(c.lidx) == len(c.weights)
    assert (ptr % sb.SLOT_GROUP == 0).all() and (np.diff(ptr) >= 0).all()
    np.testing.assert_array_equal(c.row_nnz.numpy(), (w != 0).sum(1))
    np.testing.assert_array_equal(
        np.diff(ptr), -(-c.row_nnz.numpy() // sb.SLOT_GROUP) * sb.SLOT_GROUP)
    for r in range(lidx.shape[0]):
        nnz = int(c.row_nnz[r])
        keep = w[r] != 0
        np.testing.assert_array_equal(
            c.lidx.numpy()[ptr[r]:ptr[r] + nnz], lidx[r][keep])
        np.testing.assert_array_equal(
            c.weights.numpy()[ptr[r]:ptr[r] + nnz], w[r][keep])
        assert not c.lidx.numpy()[ptr[r] + nnz:ptr[r + 1]].any()
        assert not c.weights.numpy()[ptr[r] + nnz:ptr[r + 1]].any()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_compact_form_reproduces_inband_product(case, dtype, rtol):
    a, c = _case_graph(case)
    kw = dict(row_tile=c["row_tile"], window=c["window"])
    graph = sb.banded_from_scipy(a, dtype=dtype, **kw)
    # the packed fields are still the TPU package's, array for array
    ref = tpu_banded.banded_from_scipy(a, dtype=dtype, **kw)
    assert_same_pack(ref, {**{f: getattr(graph, f).numpy() for f in FIELDS},
                           **{g: getattr(graph, g) for g in GEOMETRY}})
    _assert_compact_is_the_packed_rows(graph)
    assert 0 < int(graph.compact.row_nnz.sum()) < graph.lidx.numel()
    x = torch.as_tensor(np.random.RandomState(5).rand(c["n"], 11)
                        .astype(dtype))
    want = sb.banded_spmm_plain(graph.lidx, graph.weights, graph.slab_starts,
                                x, graph.row_tile, graph.slab_rows)
    got = compact_inband_plain(graph.compact, graph.slab_starts, x,
                               graph.row_tile)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_compact_form_of_empty_full_and_ragged_rows(dtype):
    """K = 0; and one graph with an all-empty row, an all-full row and
    counts that run from 0 to K, its non-zero slots scattered in the row."""
    empty = sb.banded_from_arrays(
        np.zeros((128, 0), np.int32), np.zeros((128, 0), dtype),
        np.zeros(2, np.int32), np.zeros((100, 0), np.int32),
        np.zeros((100, 0), dtype), np.zeros(0, np.int32),
        np.zeros(0, np.int32), np.zeros(0, dtype), np.zeros(100, dtype), 100,
        64, 96)
    assert empty.compact.lidx.shape == (0,)
    assert not empty.compact.row_ptr.any() and not empty.compact.row_nnz.any()
    x = torch.ones((100, 3), dtype=empty.dtype)
    y = compact_inband_plain(empty.compact, empty.slab_starts, x, 64)
    assert y.shape == (128, 3) and not y.any()

    n, k, tile, window = 256, 10, 64, 32
    rs = np.random.RandomState(8)
    starts = np.clip(np.arange(n // tile) * tile - window, 0,
                     n - (tile + 2 * window)).astype(np.int32)
    lidx = rs.randint(0, tile + 2 * window, (n, k)).astype(np.int32)
    w = (rs.rand(n, k) * 0.9 + 0.1).astype(dtype)
    counts = np.arange(n) % (k + 1)
    counts[5], counts[6] = 0, k  # an all-empty row beside an all-full one
    keep = np.arange(k)[None, :] < counts[:, None]
    keep = np.take_along_axis(keep, np.argsort(rs.rand(n, k), axis=1), axis=1)
    graph = sb.banded_from_arrays(
        np.where(keep, lidx, 0), np.where(keep, w, 0).astype(dtype), starts,
        np.zeros((n, 0), np.int32), np.zeros((n, 0), dtype),
        np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, dtype),
        np.zeros(n, dtype), n, tile, tile + 2 * window)
    _assert_compact_is_the_packed_rows(graph)
    np.testing.assert_array_equal(graph.compact.row_nnz.numpy(), counts)
    x = torch.as_tensor(rs.rand(n, 7).astype(dtype))
    want = sb.banded_spmm_plain(graph.lidx, graph.weights, graph.slab_starts,
                                x, tile, tile + 2 * window)
    got = compact_inband_plain(graph.compact, graph.slab_starts, x, tile)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())
    assert not got[5].any() and got[6].any()


def test_compact_slots_read_rows_beyond_x_as_zeros():
    """N below the slab: slab rows at or beyond N contribute nothing, in
    the packed and in the compacted product alike."""
    a, c = _case_graph("below_slab")
    graph = sb.banded_from_scipy(a, row_tile=c["row_tile"],
                                 window=c["window"])
    x = torch.as_tensor(np.random.RandomState(6).rand(c["n"] - 40, 4))
    want = sb.banded_spmm_plain(graph.lidx, graph.weights, graph.slab_starts,
                                x, graph.row_tile, graph.slab_rows)
    got = compact_inband_plain(graph.compact, graph.slab_starts, x,
                               graph.row_tile)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F64_RTOL,
                               atol=1e-13)


def test_kernel_picks_its_vector_width():
    assert sb.gather_vec(50, 4, 0, 0) == 2  # 50 float32 columns: pairs
    assert sb.gather_vec(52, 4, 256, 512) == 4
    assert sb.gather_vec(52, 4, 8, 512) == 2  # x not on 16 bytes
    assert sb.gather_vec(7, 4, 0, 0) == 1
    assert sb.gather_vec(50, 8, 0, 0) == 2  # float64: 16 bytes are a pair
    assert sb.gather_vec(52, 8, 8, 0) == 1
