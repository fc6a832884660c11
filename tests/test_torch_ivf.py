"""cna_tpu_torch's IVF kNN (``ops.ivf``, ``pp.ivf_fine``, ``pp.ivf``)
against cna_tpu's.

The CUDA scoring kernel runs only on a card; here its plain version (what
a CPU tensor takes) is held to cna_tpu's Pallas kernel in interpret mode
and to its XLA twin, and the index, the probe table, the finalize step and
the whole search to cna_tpu's on the same inputs.  The kernel itself is
held to its plain version on the card by ``test_torch_card.py`` and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cna_tpu.ops.ivf_pallas import score_blocks_pallas, score_blocks_xla
from cna_tpu.pp import ivf_fine as tpu_fine
from cna_tpu_torch.ops import _build
from cna_tpu_torch.ops import ivf as ivf_ops
from cna_tpu_torch.pp import ivf_fine
from cna_tpu_torch.pp.ivf import exact_knn_sample, ivf_knn, measured_recall
from cna_tpu_torch.pp.knn import knn_search
from cna_tpu_torch.utils import fine_index_from_numpy

from .torch_parity import dyadic, torch_cpu_x64  # noqa: F401

# squared distances in float32: the Pallas kernel drops 11 mantissa bits
# (relative error 2^-12) and sums the expansion |q|^2+|x|^2-2q.x, the plain
# version sums (q-x)^2 directly
DIST_TOL = 1e-3


def _layout(seed, f_pad, g, d, d_pad, n_dummy, min_count=40):
    """A random fine-block layout as numpy: x4 (f_pad, g, d_pad) with
    dead rows zeroed, ragged counts, trailing dummy blocks, csum."""
    rng = np.random.RandomState(seed)
    x4 = np.zeros((f_pad, g, d_pad), np.float32)
    x4[:, :, :d] = rng.randn(f_pad, g, d)
    counts = rng.randint(min_count, g + 1, f_pad).astype(np.int32)
    if n_dummy:
        counts[-n_dummy:] = 0
    for b in range(f_pad):
        x4[b, counts[b]:] = 0.0
    csum = (np.cumsum(counts) - counts).astype(np.int32)
    return rng, x4, counts, csum


def _plain(x4, sel, probes, counts, csum, k, g, q_blocks, width):
    """The port's scorer on the first ``width`` columns of a TPU-width
    layout (its padding columns are zero)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    negd, idx = ivf_ops.score_blocks(
        t(x4[:, :, :width]), t(sel), t(probes), t(counts), t(csum), k, g=g,
        q_blocks=q_blocks)
    assert negd.dtype == torch.float32 and idx.dtype == torch.int32
    return negd.numpy(), idx.numpy()


def _assert_same_topk(negd, idx, ref_negd, ref_idx, live,
                      ref_loses_zero_id=False):
    """Distances within DIST_TOL (absolute and relative); ids equal except
    where the distances tie within that tolerance; live rows only.
    ``ref_loses_zero_id``: the Pallas kernel packs ids into the low
    mantissa bits, which a distance that rounds to 0 cannot carry, so it
    may lose the id of one such entry per row (tests/test_ivf_fine.py:50
    allows the same)."""
    a, b = -negd[live], -ref_negd[live]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    np.testing.assert_allclose(a, b, rtol=DIST_TOL, atol=DIST_TOL)
    ia, ib = idx[live], ref_idx[live]
    for r in np.flatnonzero((np.sort(ia, 1) != np.sort(ib, 1)).any(1)):
        # the ids only one side holds carry the same distances within tol
        only_a = np.sort(a[r][~np.isin(ia[r], ib[r])])
        only_b = np.sort(b[r][~np.isin(ib[r], ia[r])])
        if ref_loses_zero_id and len(only_a) == len(only_b) + 1:
            assert only_a[0] <= DIST_TOL, r
            only_a = only_a[1:]
        np.testing.assert_allclose(only_a, only_b, rtol=DIST_TOL,
                                   atol=DIST_TOL)


def _live_rows(sel, counts, g, q_blocks):
    qblk = sel[:, None] * q_blocks + np.arange(q_blocks)
    return (np.arange(g)[None, None, :]
            < counts[qblk][:, :, None]).reshape(len(sel), q_blocks * g)


def test_scorer_matches_pallas_kernel_and_numpy():
    """The shapes of tests/test_ivf_fine.py:17-54."""
    g, d_pad, f_pad, k = 128, 128, 32, 8
    rng, x4, counts, csum = _layout(0, f_pad, g, d_pad, d_pad, n_dummy=4)
    sel = np.asarray([0, 3, 7, 11], np.int32)
    probes = np.stack([rng.permutation(f_pad)[:16] for _ in sel]).astype(
        np.int32)
    ref_negd, ref_idx = score_blocks_pallas(
        jnp.asarray(x4), jnp.asarray(sel), jnp.asarray(probes),
        jnp.asarray(counts), jnp.asarray(csum), k, q_blocks=1,
        interpret=True)
    negd, idx = _plain(x4, sel, probes, counts, csum, k, g, 1, d_pad)
    live = _live_rows(sel, counts, g, 1)
    _assert_same_topk(negd, idx, np.asarray(ref_negd), np.asarray(ref_idx),
                      live, ref_loses_zero_id=True)
    # rows beyond a block's live count are defined here: -inf, id 0
    assert np.isneginf(negd[~live]).all() and (idx[~live] == 0).all()
    # and against a direct numpy computation
    for si, s in enumerate(sel):
        cand = np.concatenate([x4[b][: counts[b]] for b in probes[si]])
        ids = np.concatenate([csum[b] + np.arange(counts[b])
                              for b in probes[si]])
        d2 = ((x4[s][: counts[s], None, :] - cand[None]) ** 2).sum(-1)
        order = np.argsort(d2, axis=1, kind="stable")[:, :k]
        np.testing.assert_allclose(
            -negd[si, : counts[s]], np.take_along_axis(d2, order, 1),
            rtol=1e-5, atol=1e-5)
        assert (np.sort(idx[si, : counts[s]], 1)
                == np.sort(ids[order], 1)).mean() > 0.999


@pytest.mark.parametrize("g,q_blocks,d,k,n_probe", [
    (128, 1, 20, 15, 32), (64, 4, 7, 10, 16), (64, 1, 12, 64, 48)])
def test_scorer_matches_xla_twin(g, q_blocks, d, k, n_probe):
    f_pad = 48
    rng, x4, counts, csum = _layout(1, f_pad, g, d, 128, n_dummy=8,
                                    min_count=1)
    n_slots = f_pad // q_blocks
    sel = rng.permutation(n_slots)[:6].astype(np.int32)
    probes = np.stack([rng.permutation(f_pad)[:n_probe]
                       for _ in sel]).astype(np.int32)
    probes[:, 16:32] = f_pad - 1 - (probes[:, 16:32] % 8)  # a dummy step
    ref_negd, ref_idx = score_blocks_xla(
        jnp.asarray(x4), jnp.asarray(sel), jnp.asarray(probes),
        jnp.asarray(counts), jnp.asarray(csum), k, g=g, q_blocks=q_blocks)
    ref_negd, ref_idx = np.asarray(ref_negd), np.asarray(ref_idx)
    negd, idx = _plain(x4, sel, probes, counts, csum, k, g, q_blocks,
                       ivf_ops.kernel_d_pad(d))
    live = _live_rows(sel, counts, g, q_blocks)
    # entries the probed set could not fill are -inf on both sides
    found = np.isfinite(ref_negd)
    assert (np.isfinite(negd) == (found & live[:, :, None])).all()
    full = live & found.all(-1)
    assert full.sum() > 100
    _assert_same_topk(negd, idx, ref_negd, ref_idx, full)


def test_wrapper_checks_and_launch_count():
    _, x4, counts, csum = _layout(2, 16, 64, 5, 8, n_dummy=2)
    t = torch.from_numpy
    sel = torch.arange(4, dtype=torch.int32)
    probes = torch.arange(16, dtype=torch.int32).repeat(4, 1)
    args = (t(x4), sel, probes, t(counts), t(csum))
    before = _build.launch_counts().get(ivf_ops.KERNEL, 0)
    negd, idx = ivf_ops.score_blocks(*args, 5, g=64)
    # a CPU tensor takes the plain version and counts no launch
    assert _build.launch_counts().get(ivf_ops.KERNEL, 0) == before
    ref = ivf_ops.score_blocks_plain(*args, 5, g=64)
    assert torch.equal(negd, ref[0]) and torch.equal(idx, ref[1])
    # every block probed: a live row finds itself first, at distance 0
    live = torch.arange(64)[None, :] < t(counts)[:4, None]
    own = t(csum)[:4, None] + torch.arange(64)[None, :]
    assert bool((idx[:, :, 0][live] == own[live]).all())
    assert bool((negd[:, :, 0][live] == 0).all())

    with pytest.raises(ValueError, match="multiple of 16"):
        ivf_ops.score_blocks(t(x4), sel, probes[:, :10].contiguous(),
                             t(counts), t(csum), 5, g=64)
    with pytest.raises(ValueError, match="power of two"):
        ivf_ops.score_blocks(t(np.ascontiguousarray(x4[:, :48])), sel,
                             probes, t(counts), t(csum), 5, g=48)
    with pytest.raises(ValueError, match="k <= 128"):
        ivf_ops.score_blocks(*args, 129, g=64)
    with pytest.raises(ValueError, match="width"):
        ivf_ops.score_blocks(t(np.ascontiguousarray(x4[:, :, :5])), sel,
                             probes, t(counts), t(csum), 5, g=64)
    with pytest.raises(TypeError, match="int32"):
        ivf_ops.score_blocks(t(x4), sel.long(), probes, t(counts), t(csum),
                             5, g=64)
    assert ivf_ops.kernel_d_pad(20) == 20 and ivf_ops.kernel_d_pad(33) == 48
    with pytest.raises(ValueError, match="at most 128"):
        ivf_ops.kernel_d_pad(129)


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpu_index():
    """cna_tpu's index of 10,000 random points (8 coordinates) and the
    points."""
    x = np.random.RandomState(3).randn(10_000, 8).astype(np.float32)
    return x, tpu_fine.build_fine_index(jnp.asarray(x), len(x), 8, seed=0)


def _carry(index, device="cpu"):
    """cna_tpu's FineIndex as the port's, through numpy."""
    return fine_index_from_numpy(
        np.asarray(index.x4), np.asarray(index.cents), index.blk_counts,
        np.asarray(index._csum_host), index.layout_rows, index.order,
        index.g, index.q_blocks, index.n, index.d_pad, index.f_real,
        device=device)


def test_layout_equal_from_same_assignments(tpu_index):
    """From cna_tpu's centroids and assignments the port lays the index
    out identically (exact equality of every layout array)."""
    x, ref = tpu_index
    # recover cna_tpu's fit: its block centroids determine nothing here,
    # so refit with its own functions on the same seed
    rng = np.random.RandomState(0)
    n, c = len(x), len(x) // 96
    chunk = int(np.clip(tpu_fine._pow2_up(int(3.5e8 // c) + 1) // 2, 256,
                        32_768))
    n_pad = tpu_fine._round_up(n, chunk)
    xp = jnp.pad(jnp.asarray(x), ((0, n_pad - n), (0, 0)))
    init = rng.choice(n, c, replace=False).astype(np.int32)
    cent = tpu_fine._kmeans_fit_matmul(
        xp, jnp.arange(n_pad) < n, jnp.asarray(init), c, 8, chunk)
    cid = np.asarray(tpu_fine._assign_chunked(xp, cent, chunk))[:n]

    got = ivf_fine._index_from_assignments(
        torch.from_numpy(x), cid, np.asarray(cent), 128, 1)
    assert got.f_pad == ref.f_pad and got.f_real == ref.f_real
    assert got.n_slots == ref.n_slots and got.n == ref.n
    for f in ("order", "layout_rows", "blk_counts"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got._csum_host, ref._csum_host)
    assert np.array_equal(got.blk_csum_dev.numpy(),
                          np.asarray(ref.blk_csum_dev))
    assert got.d_pad == 8 and ref.d_pad == 128
    assert np.array_equal(got.x4.numpy(), np.asarray(ref.x4)[:, :, :8])
    # block centroids: masked float32 means, summed in two libraries
    real = ref.blk_counts > 0
    np.testing.assert_allclose(got.cents.numpy()[real],
                               np.asarray(ref.cents)[real, :8], rtol=1e-5,
                               atol=1e-6)
    assert (got.cents.numpy()[~real] == np.float32(1e15)).all()
    assert [got.slot_compact_range(s) for s in (0, 7, got.n_slots - 1)] == \
        [ref.slot_compact_range(s) for s in (0, 7, ref.n_slots - 1)]


def test_one_lloyd_step_equal_on_dyadic_points():
    """One Lloyd step from the same init: on dyadic-rounded points the
    distance matmuls are exact in both libraries, so the assignments are
    equal and the centroids agree within 1e-6."""
    x = dyadic(np.random.RandomState(4).randn(3_000, 6), bits=6).astype(
        np.float32)
    n, c, chunk = len(x), 40, 1024
    n_pad = 3 * chunk
    xp = np.zeros((n_pad, 6), np.float32)
    xp[:n] = x
    init = np.random.RandomState(5).choice(n, c, replace=False)
    valid = np.arange(n_pad) < n
    ref = np.asarray(tpu_fine._kmeans_fit_matmul(
        jnp.asarray(xp), jnp.asarray(valid),
        jnp.asarray(init.astype(np.int32)), c, 1, chunk))
    got = ivf_fine._kmeans_fit_matmul(
        torch.from_numpy(xp), torch.from_numpy(valid),
        torch.from_numpy(init), c, 1, chunk)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    init_cent = jnp.asarray(xp[init])
    cid_ref = np.asarray(tpu_fine._assign_chunked(jnp.asarray(xp), init_cent,
                                                  chunk))[:n]
    cid = ivf_fine._assign_chunked(torch.from_numpy(x),
                                   torch.from_numpy(xp[init]), chunk)
    assert np.array_equal(cid.numpy(), cid_ref)


def test_kmeans_is_repeatable():
    x = torch.from_numpy(
        np.random.RandomState(6).randn(4_096, 5).astype(np.float32))
    args = (x, torch.ones(4_096, dtype=torch.bool), torch.arange(0, 4_096, 64),
            64, 4, 1024)
    a = ivf_fine._kmeans_fit_matmul(*args)
    b = ivf_fine._kmeans_fit_matmul(*args)
    assert torch.equal(a, b)


def _one_hot_update(x, cid, valid, cent):
    """The Lloyd update the segmented one replaced: an exact 0/1 one-hot of
    the valid rows multiplied back, ``oh.T @ x``."""
    c = cent.shape[0]
    oh = ((cid.long()[:, None] == torch.arange(c)[None, :])
          & valid[:, None]).to(x.dtype)
    cnts = oh.sum(dim=0)
    new = (oh.T @ x) / torch.clamp(cnts, min=1.0)[:, None]
    return torch.where(cnts[:, None] > 0, new, cent)


@pytest.mark.parametrize("n,d,c,seed", [(3_000, 6, 40, 7), (513, 20, 97, 8)])
def test_segmented_update_equals_one_hot_on_dyadic_points(n, d, c, seed):
    """On dyadic points every sum is exact in float32 and float64, so the
    fixed-order segmented update gives the one-hot matmul's centroids bit
    for bit: invalid rows take no part, an empty cluster keeps its
    centroid."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(dyadic(rng.randn(n, d), bits=6).astype(np.float32))
    cent = torch.from_numpy(dyadic(rng.randn(c, d), bits=6).astype(
        np.float32))
    cid = torch.from_numpy(rng.randint(0, c, n).astype(np.int32))
    cid[cid == 3] = 4                        # cluster 3 has no row
    valid = torch.from_numpy(rng.rand(n) > 0.2)
    cid[~valid & (cid == 5)] = 6
    valid[cid == 6] = False                  # cluster 6 has only invalid rows
    got = ivf_fine._lloyd_update(x, cid, valid, cent)
    want = _one_hot_update(x, cid, valid, cent)
    assert torch.equal(got, want)
    assert torch.equal(got[3], cent[3]) and torch.equal(got[6], cent[6])
    assert not torch.equal(got[4], cent[4])


def test_kmeans_assign_on_cpu_equals_assign_chunked():
    """The wrapper on a CPU tensor is the plain version: the ids of
    ``_assign_chunked`` as int32 (whatever the chunk), each with its
    direct float32 squared distance."""
    from cna_tpu_torch.ops import kmeans

    x = torch.from_numpy(
        np.random.RandomState(9).randn(2_000, 7).astype(np.float32))
    cent = x[::37].contiguous()
    before = dict(_build.launch_counts())
    ids, dist = kmeans.kmeans_assign(x, cent, chunk=300)
    assert _build.launch_counts() == before
    assert ids.dtype == torch.int32 and dist.dtype == torch.float32
    assert ids.shape == dist.shape == (2_000,)
    assert torch.equal(ids.long(), ivf_fine._assign_chunked(x, cent, 256))
    assert torch.equal(ids, kmeans.kmeans_assign(x, cent)[0])
    assert torch.equal(dist, ((x - cent[ids.long()]) ** 2).sum(1))
    full = ((x[:, None, :] - cent[None]) ** 2).sum(-1)
    assert bool((dist <= full.min(1).values * (1 + 1e-5)).all())
    assert bool((dist[::37] == 0).all())


@pytest.mark.parametrize("what", ["float64", "non_contiguous", "d129"])
def test_kmeans_assign_rejects_what_the_kernel_cannot_take(what):
    """Raised on every device, before the route is chosen."""
    from cna_tpu_torch.ops import kmeans

    x = torch.randn(64, 8)
    cent = x[:4].contiguous()
    if what == "float64":
        args, err = (x.double(), cent.double()), TypeError
    elif what == "non_contiguous":
        args, err = (torch.randn(8, 64).T, cent), ValueError
    else:
        args, err = (torch.randn(64, 129), torch.randn(4, 129)), ValueError
    with pytest.raises(err):
        kmeans.kmeans_assign(*args)


def test_kmeans_fit_is_repeatable_with_the_segmented_update():
    """Invalid rows and a duplicated initial centroid: the fit gives the
    same bits twice, no invalid row moves a centroid, and after one
    iteration the duplicate, whose cluster is empty (ties go to the lower
    id), keeps its position."""
    x = torch.from_numpy(
        np.random.RandomState(10).randn(4_096, 5).astype(np.float32))
    valid = torch.arange(4_096) < 4_000
    init = torch.arange(0, 3_968, 62)
    init[1] = init[0]
    args = (x, valid, init, 64, 4, 1024)
    a = ivf_fine._kmeans_fit_matmul(*args)
    b = ivf_fine._kmeans_fit_matmul(*args)
    assert torch.equal(a, b)
    far = x.clone()
    far[4_000:] = 1e6
    assert torch.equal(ivf_fine._kmeans_fit_matmul(far, *args[1:]), a)
    one = ivf_fine._kmeans_fit_matmul(x, valid, init, 64, 1, 1024)
    assert torch.equal(one[1], x[0]) and not torch.equal(one[0], x[0])


def test_compact_coordinates_roundtrip():
    """The invariants of tests/test_ivf_fine.py's
    test_compact_coordinates_roundtrip, on the port's own index."""
    n = 10_000
    x = np.random.RandomState(3).randn(n, 8).astype(np.float32)
    idx = ivf_fine.build_fine_index(torch.from_numpy(x), n, 8, seed=0)
    assert sorted(idx.order) == list(range(n))
    blk = idx.layout_rows // idx.g
    within = idx.layout_rows % idx.g
    assert (within < idx.blk_counts[blk]).all()
    assert len(np.unique(idx.layout_rows)) == n
    # compact index == position: csum[blk] + within is the identity
    np.testing.assert_array_equal(
        idx.blk_csum_dev.numpy()[blk] + within, np.arange(n))
    # the layout holds the points
    flat = idx.x4.reshape(-1, idx.d_pad).numpy()
    assert np.array_equal(flat[idx.layout_rows][:, :8], x[idx.order])
    assert idx.f_pad % 16 == 0 and idx.blk_counts[idx.f_real:].sum() == 0


def test_fpad_bucket_stable_across_seeds():
    x = torch.from_numpy(
        np.random.RandomState(2).randn(30_000, 12).astype(np.float32))
    f_pads = {ivf_fine.build_fine_index(x, 30_000, 12, seed=s).f_pad
              for s in (0, 1)}
    assert len(f_pads) == 1, f_pads
    for v in (1, 17, 1000, 1023, 14_000):
        assert ivf_fine._bucket16(v) == tpu_fine._bucket16(v)


# ---------------------------------------------------------------------------
# probe table, finalize
# ---------------------------------------------------------------------------


def test_rank_table_own_block_first_and_same_lists(tpu_index):
    _, ref = tpu_index
    index = _carry(ref)
    u = 32
    table = ivf_fine._rank_blocks_centroid(index.cents, u).numpy()
    ref_table = np.asarray(tpu_fine._rank_blocks_centroid(ref.cents, u))
    assert table.dtype == np.int32 and table.shape == ref_table.shape
    assert (table >= 0).all() and (table < index.f_pad).all()
    assert (table[:, 0] == np.arange(index.f_pad)).all()  # self first
    assert all(len(set(row)) == len(row) for row in table)
    # lists equal as sets in at least 99% of entries, real blocks only
    real = ref.blk_counts > 0
    hits = np.mean([np.isin(a, b).mean()
                    for a, b in zip(table[real], ref_table[real])])
    assert hits >= 0.99, hits
    # random centroids, no dummies (tests/test_ivf_fine.py:57-63)
    cents = torch.from_numpy(
        np.random.RandomState(1).randn(64, 16).astype(np.float32))
    t2 = ivf_fine._rank_blocks_centroid(cents, 16).numpy()
    assert (t2[:, 0] == np.arange(64)).all()
    # all-dummy rows keep every id in range
    cents[40:] = 1e15
    t3 = ivf_fine._rank_blocks_centroid(cents, 64).numpy()
    assert (np.sort(t3, 1) == np.arange(64)).all()
    assert (t3[:40, :40] < 40).all()  # real blocks rank dummies last


def test_finalize_equal(tpu_index):
    _, ref = tpu_index
    rng = np.random.RandomState(8)
    n, k = ref.n, 6
    rows = ref.f_pad * ref.g
    negd = -np.sort(rng.rand(rows, k).astype(np.float32), axis=1)
    idx = rng.randint(0, n, (rows, k)).astype(np.int32)
    # plant the self entry in some column of most rows, at distance 0
    compact = np.arange(n)
    col = rng.randint(0, k, n)
    planted = rng.rand(n) < 0.8
    lr = ref.layout_rows
    idx[lr[planted], col[planted]] = compact[planted]
    negd[lr[planted], 0] = 0.0
    ri, rd = tpu_fine._finalize(jnp.asarray(negd), jnp.asarray(idx),
                                jnp.asarray(lr), n)
    gi, gd = ivf_fine._finalize(torch.from_numpy(negd), torch.from_numpy(idx),
                                torch.from_numpy(lr.astype(np.int64)), n)
    assert gi.dtype == torch.int32 and gd.dtype == torch.float32
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    # the same float32 inputs through two libraries' sqrt: one ulp
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=2e-7, atol=0)
    assert (gi.numpy()[:, 0] == compact).all() and (gd.numpy()[:, 0] == 0).all()


def test_search_on_a_carried_index_matches(tpu_index):
    """Scoring cna_tpu's own index with the port's scorer and probe table
    gives cna_tpu's neighbours (its XLA scorer, its probe table)."""
    x, ref = tpu_index
    index = _carry(ref)
    u, k = 48, 10
    slots = np.arange(index.n_slots)
    batches = ivf_fine._score_slots(index, u, slots, k, {})
    assert sum(cnt for _, _, cnt in batches) == index.n_slots
    negd = torch.cat([b[0] for b in batches]).reshape(-1, k)
    idx = torch.cat([b[1] for b in batches]).reshape(-1, k)
    gi, gd = ivf_fine._finalize(
        negd, idx, torch.from_numpy(index.layout_rows.astype(np.int64)),
        index.n)
    ref_b = tpu_fine._score_slots(ref, u, slots, k, False, {}, scorer="xla")
    rn = jnp.concatenate([b[0][:c] for b in ref_b for c in [b[2]]])
    ri = jnp.concatenate([b[1][:c] for b in ref_b for c in [b[2]]])
    ri, rd = tpu_fine._finalize(rn.reshape(-1, k), ri.reshape(-1, k),
                                jnp.asarray(ref.layout_rows), ref.n)
    ri, rd = np.asarray(ri), np.asarray(rd)
    # distances: float32, expansion against direct differences
    np.testing.assert_allclose(gd.numpy(), rd, rtol=DIST_TOL, atol=DIST_TOL)
    same = np.mean(np.sort(gi.numpy(), 1) == np.sort(ri, 1))
    assert same > 0.99, same  # probe lists differ in < 1% of entries
    # pulled sample rows are the finalized rows before the self swap
    q = np.random.RandomState(9).choice(index.n, 50, replace=False)
    got = ivf_fine._pull_sample_rows(batches, slots, index, q, k)
    assert (np.sort(got, 1) == np.sort(gi.numpy()[q], 1)).mean() > 0.99


# ---------------------------------------------------------------------------
# ivf_knn end to end (tests/test_ivf.py)
# ---------------------------------------------------------------------------


def _manifold_points(n, d_latent=2, d=20, seed=0):
    rng = np.random.RandomState(seed)
    t = rng.rand(n, d_latent) * 4
    proj = rng.randn(d_latent, d)
    return (np.sin(t @ proj) + 0.05 * rng.randn(n, d)).astype(np.float32)


def _recall_vs_exact(x, idx, k, stride):
    q = np.arange(0, len(x), stride)
    truth = exact_knn_sample(x, q, k, exact=True)
    return np.mean([len(set(idx[i]) & set(t)) / k for i, t in zip(q, truth)])


def test_ivf_recall_manifold():
    n, k = 12_000, 10
    x = _manifold_points(n)
    idx, dist = ivf_knn(x, k, seed=0)
    assert idx.dtype == np.int32 and dist.dtype == np.float32
    assert _recall_vs_exact(x, idx, k, 11) >= 0.9
    # contract: self first at distance 0, distances ascending
    assert (idx[:, 0] == np.arange(n)).all()
    assert (dist[:, 0] == 0).all()
    assert (np.diff(dist, axis=1) >= 0).all()
    # the same index through knn_search, and repeatable for one seed
    idx2, dist2 = knn_search(x, k, method="ivf")
    assert np.array_equal(idx2, idx) and np.array_equal(dist2, dist)


def test_ivf_recall_escalation(capsys):
    """Starting from a hopeless probe count on an index too small for a
    pilot, the measured-recall loop escalates until the returned
    neighbours meet the floor (tests/test_ivf.py:30-41)."""
    x = np.random.RandomState(2).randn(3_000, 16).astype(np.float32)
    idx, _ = ivf_knn(x, 10, n_clusters=8, g=64, u0=1, min_recall=0.95,
                     seed=0)
    err = capsys.readouterr().err
    assert "pp.ivf: measured recall@10" in err and "escalating u" in err, err
    assert "pilot" not in err
    assert _recall_vs_exact(x, idx, 10, 7) > 0.92


def test_ivf_pilot_calibration(capsys):
    """With many slots the probe count is calibrated on a slot-subsample
    pilot (tests/test_ivf.py:78-88)."""
    n, k = 12_000, 10
    x = np.random.RandomState(5).randn(n, 8).astype(np.float32)
    idx, _ = ivf_knn(x, k, n_clusters=256, g=64, u0=1, min_recall=0.9,
                     seed=0)
    err = capsys.readouterr().err
    assert "pp.ivf pilot" in err and "trying" in err, err  # it engaged
    assert "searching" in err, err
    assert _recall_vs_exact(x, idx, k, 17) > 0.87
    assert measured_recall(torch.from_numpy(x), idx, k, seed=5) > 0.87


def test_ivf_handles_unbalanced_clusters():
    # one dense blob + a sparse tail: clusters span several blocks; probe
    # everything, so recall must be ~perfect (tests/test_ivf.py:95-112)
    rng = np.random.RandomState(1)
    x = np.concatenate([
        rng.randn(5000, 8) * 0.1,
        rng.randn(600, 8) * 3.0 + 5.0,
    ]).astype(np.float32)
    idx, dist = ivf_knn(x, 8, n_clusters=16, u0=10**5, min_recall=None,
                        seed=0)
    assert idx.shape == (5600, 8)
    assert _recall_vs_exact(x, idx, 8, 13) > 0.99
    assert (idx[:, 0] == np.arange(5600)).all() and (dist[:, 0] == 0).all()


def test_devices_argument_names_its_roadmap_item():
    """``devices=`` (the item that ROADMAP queue 1 item 8 ported) deals
    the slot batches over its devices, each against a replica of the
    index: the result equals the one-device search bit for bit, pilot
    included."""
    x = np.random.RandomState(2).randn(12_000, 4).astype(np.float32)
    one = ivf_knn(x, 10, n_clusters=256, g=64, u0=1, seed=0)
    two = ivf_knn(x, 10, n_clusters=256, g=64, u0=1, seed=0,
                  devices=["cpu", "cpu"])
    np.testing.assert_array_equal(two[0], one[0])
    np.testing.assert_array_equal(two[1], one[1])


# --- the CUDA kernel's TF32 candidate filter (ops.ivf.filter_bound) ---------
#
# The kernel looks at a candidate exactly unless its TF32 key reaches the
# row's threshold.  Here the key is emulated in torch: operands centred on the
# query block's centroid in float32, rounded to TF32's 11 significand bits
# (by masking the low 13 mantissa bits, and by rounding to nearest as
# `cvt.rna` does), multiplied and summed exactly (float64) onto the float32
# norm term that the accumulator starts from, on seeded numpy data.  No
# candidate whose float32 distance beats a threshold tau may have a key at or
# above ``_filter_threshold(tau, ...)``, for the tightest tau there is (the
# next float32 above the candidate's own distance).


def _filter_threshold(tau, nq, eps, gam):
    """The filter's per-row threshold for a current k-th distance ``tau``
    and centred squared norm ``nq``, in float32 as the kernel evaluates it
    (``filter_threshold`` of ``csrc/dist_tile.cuh``): a key at or above it
    is dropped."""
    tau = tau.to(torch.float32)
    nq = nq.to(torch.float32)
    one_minus = torch.tensor(1.0, dtype=torch.float32) - torch.tensor(
        eps, dtype=torch.float32)
    return torch.addcmul(tau, tau, torch.tensor(gam, dtype=torch.float32)) \
        - nq * one_minus


def _tf32(t, mode):
    bits = t.contiguous().view(torch.int32)
    if mode == "nearest":  # ties away from zero, on the magnitude bits
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _filter_keys(q, x, d_pad, mode):
    """(keys (m, n) float32, nq (m,) float32) as the kernel forms them for
    a query block ``q`` (m, d_pad) and candidates ``x`` (n, d_pad)."""
    eps, _ = ivf_ops.filter_bound(d_pad)
    one_minus = torch.tensor(1.0, dtype=torch.float32) - torch.tensor(
        eps, dtype=torch.float32)
    cen = (q.sum(0) / q.shape[0]).to(torch.float32)
    qc, xc = q - cen, x - cen
    nq = (qc * qc).sum(1)
    start = (xc * xc).sum(1) * one_minus
    a = _tf32(-2.0 * qc, mode).double()
    b = _tf32(xc, mode).double()
    return (start.double()[None, :] + a @ b.T).to(torch.float32), nq


def _assert_filter_keeps_every_closer_candidate(q, x, k, mode):
    d_pad = q.shape[1]
    eps, gam = ivf_ops.filter_bound(d_pad)
    keys, nq = _filter_keys(q, x, d_pad, mode)
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)  # float32, direct
    assert d2.dtype == torch.float32
    # the tightest threshold a candidate must still pass
    tau = torch.nextafter(d2, torch.full_like(d2, float("inf")))
    thr = _filter_threshold(tau, nq[:, None], eps, gam)
    assert bool((keys < thr).all()), float((keys - thr).max())
    # and at the row's final k-th distance no member of the top-k is lost
    kth = torch.sort(d2, dim=1).values[:, min(k, x.shape[0]) - 1]
    thr_k = _filter_threshold(kth, nq, eps, gam)[:, None]
    assert bool((keys < thr_k)[d2 < kth[:, None]].all())
    return float((keys < thr_k).float().mean())  # share let through


def _filter_data(kind, seed, m, n, d, d_pad):
    rng = np.random.RandomState(seed)
    q = rng.randn(m, d)
    x = np.concatenate([rng.randn(n - m, d) * rng.choice([0.5, 1.0, 3.0]),
                        q])  # the block's own rows are candidates too
    if kind == "offset":  # norms 1e3 times the neighbour distances
        shift = 1000.0 * np.sqrt(d) * rng.choice([-1.0, 1.0], d)
        q, x = q + shift, x + shift
    elif kind == "far_offset":  # candidates of other, far-away blocks
        x[: n // 2] += 300.0 * rng.randn(1, d)
    elif kind == "duplicates":
        x[: n // 2] = x[n // 2: 2 * (n // 2)]
        q[1::2] = q[::2][: len(q[1::2])]
    elif kind == "identical":
        q[:] = q[0]
        x[: n // 2] = q[0]
    elif kind == "tiny_spread":
        q, x = 1000.0 + 1e-3 * q, 1000.0 + 1e-3 * x
    out = []
    for a in (q, x):
        p = np.zeros((a.shape[0], d_pad), np.float32)
        p[:, :d] = a
        out.append(torch.from_numpy(p))
    return out


@pytest.mark.parametrize("mode", ["mask", "nearest"])
@pytest.mark.parametrize("kind", ["random", "offset", "far_offset",
                                  "duplicates", "identical", "tiny_spread"])
@pytest.mark.parametrize("d", [3, 20, 24, 100])
def test_filter_never_drops_a_closer_candidate(kind, d, mode):
    d_pad = ivf_ops.kernel_d_pad(d)
    q, x = _filter_data(kind, seed=d, m=96, n=512, d=d, d_pad=d_pad)
    share = _assert_filter_keeps_every_closer_candidate(q, x, 15, mode)
    if kind == "random" and d >= 20:
        # and it is a filter: centred blocks let little more than the
        # top-k through (15 of 512 are 0.03)
        assert share < 0.06, share


def test_filter_bound_terms():
    u, v = 2.0 ** -24, 2.0 ** -10
    eps, gam = ivf_ops.filter_bound(20)
    assert eps == 2 * v + v * v + (36 * 3 + 40 + 16) * u
    assert gam == 2 * 28 * u
    widths = [ivf_ops.filter_bound(w) for w in ivf_ops.D_PADS]
    assert all(a[0] < b[0] and a[1] < b[1]
               for a, b in zip(widths, widths[1:]))
    assert all(2 * v < e < 2.2 * v and g < 1e-4 for e, g in widths)
    with pytest.raises(ValueError, match="d_pad"):
        ivf_ops.filter_bound(129)
    # the threshold of a row that has no k-th distance yet lets all through
    thr = _filter_threshold(torch.tensor([float("inf"), 0.0]),
                            torch.tensor([3.0, 3.0]), eps, gam)
    assert thr[0] == float("inf") and thr[1] == -3.0 * (1 - np.float32(eps))
