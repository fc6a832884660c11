"""The diffusion step's gather SpMM (``ops.spmm``, ``csrc/gather_spmm.cu``):
on the CPU the host side (the bucket table, the launch shape, the plain
path taken for CPU tensors and its result, the ``spmm_kernel`` counter),
on the card the kernel against its plain version.

The card tests (marker ``gpu``) skip without a card.  This file imports
neither JAX nor cna_tpu, so it runs where the port runs; on the card's
machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_spmm.py -m gpu
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

import cna_tpu_torch as ct
from cna_tpu_torch.graph import device
from cna_tpu_torch.graph.device import DeviceConnectivities, SortedExtGraph
from cna_tpu_torch.graph.ell import EllGraph
from cna_tpu_torch.ops import _build, spmm
from cna_tpu_torch.utils import profiling

from .torch_parity import brute_knn, need_cuda, torch_cpu_x64  # noqa: F401

# ``pp`` re-exports a function named ``neighbors``, which hides the module
nb = importlib.import_module("cna_tpu_torch.pp.neighbors")

# the kernel against the plain version, relative to max |y|: another
# summation order at the state's own precision (about 22 terms a row)
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _hubby_points(n, seed):
    """A dense core inside a diffuse cloud: asymmetric kNN (mirror edges)
    and hub rows (mirror buckets of several widths and a COO spill)."""
    rng = np.random.RandomState(seed)
    return np.concatenate([
        rng.randn(n - n // 6, 10), rng.randn(n // 6, 10) * 0.05])


@pytest.fixture(scope="module")
def union():
    """kNN lists of 2,400 hubby points and the port's fuzzy-union weights
    and codes for them (float64, on the CPU)."""
    k = 15
    idx, d2 = brute_knn(_hubby_points(2400, 0), k)
    idx = torch.from_numpy(idx.astype(np.int32))
    dists = torch.from_numpy(np.sqrt(d2))
    rho, sigma = nb.smooth_knn_dist(dists, math.log2(k))
    w = nb.membership_strengths(dists, rho, sigma, idx)
    w_sym, code = nb.fuzzy_union_device(idx, w)
    return idx, w_sym, code


def _graph(union, dtype, dev, ell_max_kx=0):
    """The hubby graph from ``build_sym_ell``: a ``SortedExtGraph`` with
    in-degree buckets and a spill (``ell_max_kx=0``), or an ``EllGraph``
    (``ell_max_kx=128``)."""
    idx, w_sym, code = (t.to(dev) for t in union)
    return device.build_sym_ell(idx, w_sym, code, dtype=dtype,
                                ell_max_kx=ell_max_kx)


def _moved(graph, dev):
    """``graph`` with every tensor on ``dev``."""
    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if isinstance(v, tuple):
            return tuple(move(t) for t in v)
        return v
    return dataclasses.replace(graph, **{
        f.name: move(getattr(graph, f.name))
        for f in dataclasses.fields(graph)})


def _overlapping(graph, extra=3):
    """``graph``'s mirror buckets as the TPU package may carry them: each
    bucket after the first starts with copies of the last ``extra`` rows
    of the bucket before it (padded with zero slots to its width), and
    ``inv_pi`` points those rows at their copies."""
    old_starts = np.cumsum([0] + [int(b.shape[0])
                                  for b in graph.ext_indices])
    pos_map = torch.zeros(int(old_starts[-1]), dtype=torch.int64)
    ids, wts, start = [], [], 0
    for b, (bi, bw) in enumerate(zip(graph.ext_indices,
                                     graph.ext_weights)):
        o = 0
        if b > 0 and graph.ext_indices[b - 1].shape[0] >= 2 * extra:
            o = extra
            pad = bi.shape[1] - graph.ext_indices[b - 1].shape[1]
            assert pad >= 0  # widths ascend with the in-degree
            bi = torch.cat([torch.nn.functional.pad(
                graph.ext_indices[b - 1][-o:], (0, pad)), bi])
            bw = torch.cat([torch.nn.functional.pad(
                graph.ext_weights[b - 1][-o:], (0, pad)), bw])
        rows = int(old_starts[b + 1] - old_starts[b])
        pos_map[old_starts[b]:old_starts[b + 1]] = (
            start + o + torch.arange(rows))
        # the copied rows are now read from this bucket
        pos_map[old_starts[b] - o:old_starts[b]] = start + torch.arange(o)
        ids.append(bi.contiguous())
        wts.append(bw.contiguous())
        start += int(bi.shape[0])
    inv = pos_map.to(graph.inv_pi.device)[graph.inv_pi]
    return dataclasses.replace(graph, ext_indices=tuple(ids),
                               ext_weights=tuple(wts), inv_pi=inv)


def _state(n, s, dtype, dev, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.rand((n, s), generator=gen, device=dev, dtype=dtype)


def _dense_step(graph, s, self_weight):
    """The reference's step from the graph's CSR, in float64 numpy:
    ``A @ (s / colsums) + self_weight * s / colsums``."""
    a = DeviceConnectivities(_moved(graph, "cpu"), None,
                             graph.n_rows).tocsr()
    s = s.cpu().double().numpy()
    c = np.asarray(a.sum(axis=0)).ravel() + self_weight
    t = s / c[:, None]
    return a @ t + self_weight * t


# ---- the host side (CPU) ------------------------------------------------


def test_bucket_table_follows_the_graphs_slices(union):
    """The table the kernel gets: each bucket's ids and weights where the
    graph keeps them, its first position in the concatenation of the
    buckets' rows (the running sum of the rows before it), its rows and
    its width; every row's ``inv_pi`` falls in one bucket, and the mirror
    slots found there through the table are the plain version's."""
    g = _graph(union, torch.float64, "cpu")
    assert isinstance(g, SortedExtGraph) and len(g.ext_indices) >= 2
    for graph in (g, _overlapping(g)):
        ptr_i, ptr_w, starts, rows, widths = spmm.bucket_table(
            graph.ext_indices, graph.ext_weights)
        assert ptr_i == [t.data_ptr() for t in graph.ext_indices]
        assert ptr_w == [t.data_ptr() for t in graph.ext_weights]
        assert rows == [t.shape[0] for t in graph.ext_indices]
        assert widths == [t.shape[1] for t in graph.ext_indices]
        assert starts == list(np.cumsum([0] + rows[:-1]))
        p = graph.inv_pi
        where = [(p >= a) & (p < a + r) for a, r in zip(starts, rows)]
        assert bool((sum(w.long() for w in where) == 1).all())
        # the kernel's lookup, in torch, against the plain mirror part
        x = _state(graph.n_rows, 5, torch.float64, "cpu")
        mirror = torch.zeros_like(x)
        for b, sel in enumerate(where):
            r = p[sel] - starts[b]
            ids = graph.ext_indices[b][r].long()
            w = graph.ext_weights[b][r]
            mirror[sel] = (w[:, :, None] * x[ids]).sum(dim=1)
        plain = spmm._bucket_outputs(graph.ext_indices, graph.ext_weights,
                                     x, spmm.ell_spmm_plain)[p]
        torch.testing.assert_close(mirror, plain, rtol=1e-13, atol=1e-13)


def test_overlapping_slices_give_the_same_product(union):
    """The carried-over layout of ``_overlapping`` is the same matrix: the
    plain product of the two agrees, and the copies are really read."""
    g = _graph(union, torch.float64, "cpu")
    h = _overlapping(g)
    assert sum(b.shape[0] for b in h.ext_indices) > g.n_rows
    assert not torch.equal(h.inv_pi, g.inv_pi)
    x = _state(g.n_rows, 7, torch.float64, "cpu", seed=1)
    torch.testing.assert_close(spmm.sorted_ext_spmm(h, x),
                               spmm.sorted_ext_spmm(g, x),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("ell_max_kx", [0, 128])
def test_cpu_tensors_take_the_plain_path_unchanged(union, ell_max_kx):
    """On the CPU ``diffusion_step``, ``ell_spmm`` and
    ``sorted_ext_spmm`` launch nothing, give ``diffusion_step_plain``'s
    and ``ell_spmm_plain``'s bits, and the step is the reference's."""
    g = _graph(union, torch.float64, "cpu", ell_max_kx)
    assert isinstance(g, SortedExtGraph if ell_max_kx == 0 else EllGraph)
    assert g.n_overflow > 0  # the spill is present
    s = _state(g.n_rows, 9, torch.float64, "cpu", seed=2)
    c = g.colsums(1.5)
    _build.reset_launch_counts()
    y = spmm.diffusion_step(s, g, c, 1.5)
    assert torch.equal(y, spmm.diffusion_step_plain(s, g, c, 1.5))
    np.testing.assert_allclose(y.numpy(), _dense_step(g, s, 1.5),
                               rtol=1e-12, atol=1e-12)
    if ell_max_kx:
        assert torch.equal(spmm.ell_spmm(g.indices, g.weights, s),
                           spmm.ell_spmm_plain(g.indices, g.weights, s))
    else:
        assert torch.equal(spmm.sorted_ext_spmm(g, s),
                           spmm.coo_spmm_add(
                               spmm._sorted_ext_plain(g, s),
                               g.overflow_rows, g.overflow_cols,
                               g.overflow_weights, s))
    assert _build.launch_counts().get(spmm.KERNEL, 0) == 0


def test_the_kernel_takes_no_tensor_off_the_card(union):
    """No fallback: the kernel's wrapper refuses a tensor that is not on
    a CUDA card (``ell_spmm`` of a ``meta`` tensor goes to it and
    raises); a CPU tensor never reaches it through the dispatch."""
    g = _graph(union, torch.float32, "cpu", 128)
    x = _state(g.n_rows, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        spmm.gather_spmm(x, g.indices, g.weights)
    meta = [t.to("meta") for t in (g.indices, g.weights, x)]
    with pytest.raises(ValueError, match="CUDA"):
        spmm.ell_spmm(*meta)


@pytest.mark.parametrize("s,itemsize,ptr,ldx,want", [
    (259, 4, 512, 259, (1, 9, 32)),   # the TB atlas: 1,036-byte rows
    (50, 4, 512, 50, (2, 1, 32)),     # bench.py's default
    (200, 4, 512, 200, (4, 2, 32)),   # the north star
    (200, 4, 4, 200, (1, 7, 32)),     # a state on a 4-byte boundary
    (200, 4, 512, 201, (1, 7, 32)),   # a row stride of another parity
    (259, 8, 512, 259, (1, 9, 32)),
    (50, 8, 512, 50, (2, 1, 32)),
    (1, 4, 512, 1, (1, 1, 1)),
    (20, 4, 512, 20, (4, 1, 8)),      # five vectors: 8 lanes a row
    (3, 8, 512, 3, (1, 1, 4)),
    (1000, 4, 512, 1000, (4, 8, 32)),
    (5000, 4, 512, 5000, (4, 16, 32)),  # column chunks of 2,048
    (700, 4, 512, 700, (4, 8, 32)),   # 6 vectors a lane, rounded to 8
])
def test_launch_shape_follows_the_state(s, itemsize, ptr, ldx, want):
    """Columns a vector (at most 16 bytes, dividing S and the row stride,
    on the state's alignment), vectors a lane, lanes a row."""
    assert spmm.launch_shape(s, itemsize, ptr, ldx) == want


def test_diffusion_span_counts_no_kernel_step_on_the_cpu():
    """``spmm_kernel`` sits beside ``steps`` on the ``diffusion`` span: 0
    on the CPU, where no step launches the kernel."""
    d, _ = ct.data.synthetic_dataset(n_samples=10, cells_per_sample=60,
                                     n_genes=10, seed=1)
    ct.pp.pca(d, n_comps=5)
    ct.pp.neighbors(d, n_neighbors=8)
    prof = profiling.enable_profiling()
    try:
        ct.tl.nam(d, "id", nsteps=3)
    finally:
        profiling.disable_profiling()
    (rec,) = [r for r in prof.phases if r["phase"] == "diffusion"]
    assert rec["steps"] == 3 and rec["spmm_kernel"] == 0


# ---- the kernel on the card ---------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [1, 50, 259])
def test_kernel_step_matches_plain_on_the_sorted_ext_graph(union, s, dtype):
    """One diffusion step of a ``SortedExtGraph`` (buckets of several
    widths, rows with no mirror edge, a spill): one launch, the plain
    version's step within another summation order, the reference's; and
    the bare product (``sorted_ext_spmm``)."""
    need_cuda()
    g = _graph(union, dtype, "cuda")
    assert isinstance(g, SortedExtGraph) and g.n_overflow > 0
    assert len(g.ext_indices) >= 2
    x = _state(g.n_rows, s, dtype, "cuda", seed=s)
    c = g.colsums(1.0)
    before = _build.launch_counts().get(spmm.KERNEL, 0)
    y = spmm.diffusion_step(x, g, c, 1.0)
    torch.cuda.synchronize()
    assert _build.launch_counts()[spmm.KERNEL] == before + 1
    ref = spmm.diffusion_step_plain(x, g, c, 1.0)
    tol = RTOL[dtype] * float(ref.abs().max())
    assert float((y - ref).abs().max()) <= tol
    np.testing.assert_allclose(y.cpu().double().numpy(),
                               _dense_step(g, x, 1.0), rtol=0,
                               atol=10 * tol)
    bare = spmm.sorted_ext_spmm(g, x)
    ref = spmm.coo_spmm_add(spmm._sorted_ext_plain(g, x), g.overflow_rows,
                            g.overflow_cols, g.overflow_weights, x)
    assert float((bare - ref).abs().max()) \
        <= RTOL[dtype] * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_steps_from_the_association_start_state(union, dtype):
    """The association's first states are mostly exact zeros: the one-hot
    of each row's sample, then its diffusion.  Three kernel steps from it,
    each held to the plain step of the same state, and the kernel's launch
    repeatable bit for bit (it leaves zero dividends out; the spill's
    ``index_add_`` is not bit-repeatable)."""
    need_cuda()
    g = _graph(union, dtype, "cuda")
    gen = torch.Generator().manual_seed(5)
    codes = torch.randint(0, 50, (g.n_rows,), generator=gen).cuda()
    x = (codes[:, None] == torch.arange(50, device="cuda")).to(dtype)
    c = g.colsums(1.0)
    args = spmm.kernel_slots(g)
    for _ in range(3):
        y = spmm.diffusion_step(x, g, c, 1.0)
        ref = spmm.diffusion_step_plain(x, g, c, 1.0)
        assert float((y - ref).abs().max()) \
            <= RTOL[dtype] * float(ref.abs().max())
        assert torch.equal(spmm.gather_spmm(x, *args, c, 1.0),
                           spmm.gather_spmm(x, *args, c, 1.0))
        x = y


def _without_first_bucket(graph):
    """``graph`` with the rows of its first mirror bucket moved into a
    bucket of width 0: those rows keep their direct edges only."""
    first = graph.ext_indices[0]
    return dataclasses.replace(
        graph,
        ext_indices=(first[:, :0].contiguous(),) + graph.ext_indices[1:],
        ext_weights=(graph.ext_weights[0][:, :0].contiguous(),)
        + graph.ext_weights[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_rows_without_mirror_edges(union, dtype):
    """Rows in a mirror bucket of width 0, and a graph with no buckets at
    all (the direct columns alone): those rows are the direct product's,
    and the other rows the plain version's."""
    need_cuda()
    g = _without_first_bucket(_graph(union, dtype, "cuda"))
    p = g.inv_pi
    empty = p < g.ext_indices[0].shape[0]
    assert bool(empty.any()) and not bool(empty.all())
    x = _state(g.n_rows, 50, dtype, "cuda", seed=3)
    c = g.colsums(1.0)
    y = spmm.gather_spmm(x, g.direct_indices, g.direct_weights,
                         g.ext_indices, g.ext_weights, p, c, 1.0)
    y0 = spmm.gather_spmm(x, g.direct_indices, g.direct_weights,
                          colsums=c, self_weight=1.0)
    t = x / c[:, None]
    ref = spmm.ell_spmm_plain(g.direct_indices, g.direct_weights, t) + t
    tol = RTOL[dtype] * float(ref.abs().max())
    assert float((y0 - ref).abs().max()) <= tol
    assert float((y[empty] - ref[empty]).abs().max()) <= tol
    step = spmm.diffusion_step(x, g, c, 1.0)
    assert float((step - spmm.diffusion_step_plain(x, g, c, 1.0))
                 .abs().max()) <= tol
    direct = dataclasses.replace(g, ext_indices=(), ext_weights=())
    step = spmm.diffusion_step(x, direct, c, 1.0)
    assert float((step - spmm.diffusion_step_plain(x, direct, c, 1.0))
                 .abs().max()) <= tol


@pytest.mark.gpu
def test_kernel_reads_overlapping_bucket_slices(union):
    """Bucket slices carried over from the TPU package (padded copies of
    rows, ``inv_pi`` pointing into a concatenation longer than N): the
    same step as the graph they came from."""
    need_cuda()
    g = _graph(union, torch.float32, "cuda")
    h = _moved(_overlapping(_moved(g, "cpu")), "cuda")
    x = _state(g.n_rows, 259, torch.float32, "cuda", seed=4)
    c = g.colsums(1.0)
    y = spmm.diffusion_step(x, h, c, 1.0)
    ref = spmm.diffusion_step_plain(x, g, c, 1.0)
    assert float((y - ref).abs().max()) \
        <= RTOL[torch.float32] * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bare_ell_spmm_and_ell_step_on_the_card(union, dtype):
    """``ell_spmm`` on an ``EllGraph`` (no division, no self term) and
    ``graph_spmm`` with its COO tail, then the ``EllGraph`` step: one
    launch each, the plain version's results."""
    need_cuda()
    g = _graph(union, dtype, "cuda", ell_max_kx=128)
    assert isinstance(g, EllGraph) and g.n_overflow > 0
    x = _state(g.n_rows, 50, dtype, "cuda", seed=5)
    before = _build.launch_counts().get(spmm.KERNEL, 0)
    y = spmm.ell_spmm(g.indices, g.weights, x)
    assert _build.launch_counts()[spmm.KERNEL] == before + 1
    ref = spmm.ell_spmm_plain(g.indices, g.weights, x)
    tol = RTOL[dtype] * float(ref.abs().max())
    assert float((y - ref).abs().max()) <= tol
    full = spmm.graph_spmm(g, x)
    ref = spmm.coo_spmm_add(ref, g.overflow_rows, g.overflow_cols,
                            g.overflow_weights, x)
    assert float((full - ref).abs().max()) <= tol
    c = g.colsums(2.0)
    step = spmm.diffusion_step(x, g, c, 2.0)
    ref = spmm.diffusion_step_plain(x, g, c, 2.0)
    assert float((step - ref).abs().max()) \
        <= RTOL[dtype] * float(ref.abs().max())


def _bits(n, dtype, gen):
    """``n`` values with uniformly random bit patterns: every binade,
    subnormals, both zeros, infinities and NaNs."""
    if dtype == torch.float32:
        raw = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                            dtype=torch.int64).to(torch.int32)
    else:
        raw = torch.randint(-2 ** 63, 2 ** 63 - 1, (n,), generator=gen,
                            dtype=torch.int64)
    return raw.view(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_quotients_are_the_ieee_division(dtype):
    """Each term's quotient is the IEEE division's bit for bit, zero
    dividends (which the kernel leaves out where that changes no bit)
    included: a graph of one edge of weight 1 a row (row i reads row
    perm[i]) and no self term gives y[i] = x[perm[i]] / d[perm[i]], held to
    torch's division on the card over dividends of random bits (every
    binade, subnormals, zeros, infinities, NaNs) and divisors likewise or
    within 2^+-21; then the self term alone, +0 + 0.75 * x[i] / d[i]."""
    need_cuda()
    gen = torch.Generator().manual_seed(7)
    n, s = 65536, 64
    x = _bits(n * s, dtype, gen).reshape(n, s)
    x[:, :4] = torch.tensor([0.0, -0.0, 1.0, -3.0], dtype=dtype)
    d = _bits(n, dtype, gen)
    near = torch.rand(n, generator=gen, dtype=torch.float64) < 0.75
    span = 2.0 ** (42 * torch.rand(n, generator=gen, dtype=torch.float64)
                   - 21)
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)
    d = torch.where(near, (span * (1 + torch.rand(n, generator=gen,
                                                  dtype=torch.float64))
                           * sign).to(dtype), d)
    x, d = x.cuda(), d.cuda()
    perm = torch.randperm(n, generator=gen).to(torch.int32).cuda()
    y = spmm.gather_spmm(x, perm[:, None].contiguous(),
                         torch.ones((n, 1), dtype=dtype, device="cuda"),
                         colsums=d)
    ref = x[perm.long()] / d[perm.long()][:, None]
    # fma(1, q, +0) turns a quotient of -0 into +0
    torch.testing.assert_close(y, ref + 0.0, rtol=0, atol=0,
                               equal_nan=True)
    # the self term alone (every slot empty): +0 + 0.75 * (x / d)
    y = spmm.gather_spmm(x, perm[:, None].contiguous(),
                         torch.zeros((n, 1), dtype=dtype, device="cuda"),
                         colsums=d, self_weight=0.75)
    ref = torch.zeros_like(x) + 0.75 * (x / d[:, None])
    torch.testing.assert_close(y, ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [50, 259])
def test_kernel_bit_identical_run_to_run(union, s):
    """No atomics in the kernel: two launches give the same bits."""
    need_cuda()
    g = _graph(union, torch.float32, "cuda")
    x = _state(g.n_rows, s, torch.float32, "cuda", seed=6)
    c = g.colsums(1.0)
    args = (x, g.direct_indices, g.direct_weights, g.ext_indices,
            g.ext_weights, g.inv_pi, c, 1.0)
    assert torch.equal(spmm.gather_spmm(*args), spmm.gather_spmm(*args))


@pytest.mark.gpu
def test_kernel_raises_on_what_it_cannot_take(union):
    """A state of another type, ids that are not int32, columns that are
    not contiguous, a column-sum vector on another device: each raises,
    none falls back."""
    need_cuda()
    g = _graph(union, torch.float32, "cuda")
    x = _state(g.n_rows, 8, torch.float32, "cuda")
    c = g.colsums(1.0)
    with pytest.raises(TypeError):
        spmm.diffusion_step(x.half(), g, c.half(), 1.0)
    with pytest.raises(TypeError):
        spmm.diffusion_step(x.double(), g, c.double(), 1.0)
    with pytest.raises(TypeError):
        spmm.gather_spmm(x, g.direct_indices.long(), g.direct_weights)
    with pytest.raises(ValueError):
        spmm.gather_spmm(_state(8, g.n_rows, torch.float32, "cuda").T,
                         g.direct_indices, g.direct_weights)
    with pytest.raises(ValueError):
        spmm.diffusion_step(x, g, c.cpu(), 1.0)


@pytest.mark.gpu
def test_nam_launches_the_kernel_once_a_step():
    """``tl.nam`` on the card: the kernel's launches equal the steps the
    ``diffusion`` span counts, and its ``spmm_kernel`` counter too."""
    need_cuda()
    try:
        ct.config.set_device("cuda")
        ct.config.enable_x64(False)
        d, _ = ct.data.synthetic_dataset(n_samples=20, cells_per_sample=500,
                                         n_genes=20, seed=2)
        ct.pp.pca(d, n_comps=10)
        ct.pp.neighbors(d, n_neighbors=15)
        prof = profiling.enable_profiling()
        ct.ops.reset_launch_counts()
        ct.tl.nam(d, "id")
        counts = ct.ops.launch_counts()
        profiling.disable_profiling()
        (rec,) = [r for r in prof.phases if r["phase"] == "diffusion"]
        assert counts == {spmm.KERNEL: rec["steps"]}
        assert rec["spmm_kernel"] == rec["steps"] >= 3
    finally:
        profiling.disable_profiling()
        ct.config.set_device("cpu")
        ct.config.enable_x64(True)
