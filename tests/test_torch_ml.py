"""The ML package: pixie_tpu_torch.ml against pixie_tpu.ml.

Same numpy inputs from a seed through both packages (the reference on the
JAX CPU, the port with device="cpu", where KM1-KM3 run their plain
versions).  The port draws its uniforms from a torch.Generator, whose
stream differs from JAX's threefry for the same seed, so the parity cases
feed JAX's own uniforms through the port's one draw function
(`pixie_tpu_torch.ml.kmeans._uniforms`), from the reference's key schedule:
PRNGKey(seed), split once for the first center and once per seeding step
(kmeans.py:34, :49), and PRNGKey(seed + 1) with shape (m,) for a coreset's
samples (coreset.py:41-42).  With the same draws both packages pick the same
indices, so chosen centers and sampled points are identical.  That needs
the two packages' sampling probabilities to agree far closer than the gaps
between their cumulative sums, and the reference's expansion
|x|^2 - 2x.c + |c|^2 loses log10(|x|^2 / d^2) digits of d^2: so the parity
data are gaussian blobs with centers at scale 10 and sigma 1 (|x|^2 / d^2
about 100).  At |x|^2 / d^2 ~ 3000 (sigma 0.3 at distance 30) the two
packages' d^2 differ by ~4e-4 relative and about one coreset sample in 100
lands on a neighbouring point; the recovery tests below cover such data.

Tolerances: distances rtol 1e-5, atol 1e-4 (float32 matmuls summed in two
orders); centers rtol 1e-5, atol 1e-5 (float32 sums; the port sums in
float64 and rounds once).  Coreset weights rtol 2e-4: they divide by the
sensitivity, which holds d^2 from the expansion, and both packages' d^2 sit
within 8 float32 ulps of |x|^2 + |c|^2 of the float64 value
(test_expansion_error_bounds_both), ~1e-4 of d^2 on these blobs, so the
weights can differ by that much in either package's favour.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu.ml import CoresetTree as RefTree, KMeans as RefKMeans
from pixie_tpu.ml import kmeans as ref_km
from pixie_tpu.ml import kmeans_coreset as ref_coreset
from pixie_tpu.ml.request_path import RequestPathClustering as RefRPC
from pixie_tpu.ml.request_path import templatize as ref_templatize

from pixie_tpu_torch import interop
from pixie_tpu_torch.ml import CoresetTree, KMeans, kmeans_coreset, kmeans_fit
from pixie_tpu_torch.ml import kmeans as km
from pixie_tpu_torch.ml.request_path import RequestPathClustering, templatize
from pixie_tpu_torch.ops import kmeans as kops
from pixie_tpu_torch.status import Unavailable

CPU = "cpu"


def _blobs(rng, centers, n_per, scale=0.1):
    pts = [rng.normal(0, scale, (n_per, len(c))) + np.asarray(c) for c in centers]
    return np.concatenate(pts)


def _data(seed=0, n=2000, d=8, k=5, weighted=True):
    rng = np.random.default_rng(seed)
    cent = rng.normal(0, 10, (k, d))
    x = (cent[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32) if weighted else np.ones(n, np.float32)
    return x, w


def _jax_plusplus_uniforms(seed: int, k: int) -> np.ndarray:
    """The k uniforms the reference's _plusplus_init draws for PRNGKey(seed):
    one per jax.random.choice, in its split order."""
    key = jax.random.PRNGKey(seed)
    k0, key = jax.random.split(key)
    us = [jax.random.uniform(k0, (), dtype=jnp.float32)]
    for _ in range(1, k):
        kc, key = jax.random.split(key)
        us.append(jax.random.uniform(kc, (), dtype=jnp.float32))
    return np.array(us, dtype=np.float32)


@pytest.fixture
def jax_draws(monkeypatch):
    """set(k) makes the port draw JAX's uniforms: a (k,) draw is a seeding
    schedule, any other shape a coreset's one draw from PRNGKey(seed)."""
    state = {"k": None}

    def uniforms(gen, shape, device):
        seed = gen.initial_seed()
        if tuple(shape) == (state["k"],):
            u = _jax_plusplus_uniforms(seed, state["k"])
        else:
            u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                              dtype=jnp.float32))
        return torch.from_numpy(u.copy()).to(device)

    monkeypatch.setattr(km, "_uniforms", uniforms)

    def set_k(k):
        state["k"] = k

    return set_k


# ----------------------------------------------------------------- kernels


@pytest.mark.parametrize("n,d,k", [(1, 3, 1), (1000, 8, 5), (777, 64, 64), (300, 13, 7)])
def test_sq_dists_matches_reference(n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = rng.normal(0, 3, (n, d)).astype(np.float32)
    c = rng.normal(0, 3, (k, d)).astype(np.float32)
    want = np.asarray(ref_km._sq_dists(jnp.asarray(x), jnp.asarray(c)))
    got = km._sq_dists(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_expansion_error_bounds_both():
    """Both packages' d^2 by the expansion lie within 8 float32 ulps of
    |x|^2 + |c|^2 of the float64 value (the bound the coreset weights'
    tolerance rests on)."""
    x, _w = _data(3)
    c = x[:5] + 0.5
    exact = ((x[:, None, :].astype(np.float64) - c[None].astype(np.float64)) ** 2).sum(-1)
    scale = (x.astype(np.float64) ** 2).sum(1)[:, None] + (c.astype(np.float64) ** 2).sum(1)
    ref = np.asarray(ref_km._sq_dists(jnp.asarray(x), jnp.asarray(c)))
    port = km._sq_dists(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    eps = np.finfo(np.float32).eps
    for got in (ref, port):
        assert np.all(np.abs(got - exact) <= 8 * eps * scale)


def test_assign_plain_is_nearest_with_lowest_index_on_ties():
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0], [5.0, 5.0]])
    c = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [5.0, 5.0]])
    ids, mind = kops.assign(x, c)
    assert ids.tolist() == [0, 0, 2]  # (0, 0) ties centers 0 and 1
    assert mind.tolist() == [1.0, 0.0, 0.0]


def test_lloyd_step_sums_by_nearest_center():
    x, w = _data(4, n=500, d=6, k=3)
    c = torch.from_numpy(x[:3].copy())
    wsum, xsum = kops.lloyd_step(torch.from_numpy(x), torch.from_numpy(w), c)
    ids = np.argmin(((x[:, None, :] - x[None, :3, :]) ** 2).sum(-1), axis=1)
    want_w = np.bincount(ids, weights=w.astype(np.float64), minlength=3)
    want_x = np.stack([(x[ids == j] * w[ids == j, None]).astype(np.float64).sum(0)
                       for j in range(3)])
    np.testing.assert_allclose(wsum.numpy(), want_w, rtol=1e-6)
    np.testing.assert_allclose(xsum.numpy(), want_x, rtol=1e-5, atol=1e-4)


def test_seed_step_folds_running_min_and_zeroes_non_finite():
    x = torch.tensor([[0.0, 0.0], [3.0, 4.0], [1.0, 0.0]])
    w = torch.tensor([1.0, 2.0, float("inf")])
    mind = torch.full((3,), float("inf"))
    p = kops.seed_step(x, w, torch.tensor([0.0, 0.0]), mind)
    assert mind.tolist() == [0.0, 25.0, 1.0]
    assert p.tolist() == [0.0, 50.0, 0.0]  # 1 * inf is not finite → 0
    p = kops.seed_step(x, w, torch.tensor([3.0, 4.0]), mind)
    assert mind.tolist() == [0.0, 0.0, 1.0] and p.tolist() == [0.0, 0.0, 0.0]


#: small forms of the card's KM2 / KM3 edge cases (tests/test_torch_cuda.py
#: _km_edge): n one short of and one past KM2's 128-point tile, more centers
#: than points, d not a multiple of 4 and over one 64-column chunk, every
#: point on one center, rows holding NaN
_EDGES = {"short": (127, 64, 64), "past": (129, 64, 64), "past_k8": (129, 64, 8),
          "k_over_n": (257, 8, 300), "d13": (300, 13, 7), "d150_k200": (1001, 150, 200),
          "skew": (1024, 64, 64), "nan": (409, 64, 64), "nan_d13": (301, 13, 7)}


def _edge(case):
    """(x, c, w) float32 for an edge case: blobs at scale 10 and sigma 1, the
    centers the blobs' moved by N(0, 0.25), weights in [0.5, 1.5)."""
    n, d, k = _EDGES[case]
    rng = np.random.default_rng(sorted(_EDGES).index(case))
    cent = rng.normal(0, 10, (k, d))
    x = cent[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))
    c = cent + rng.normal(0, 0.5, (k, d))
    if case == "skew":
        x = c[5] + 0.1 * rng.normal(0, 1, (n, d))
    if case.startswith("nan"):
        x[::97, 3] = np.nan
        x[5] = np.nan
    w = rng.random(n) + 0.5
    return x.astype(np.float32), c.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("case", sorted(_EDGES))
def test_one_lloyd_step_matches_reference_at_the_kernels_edges(case):
    """A NaN row's distances are all NaN: both argmins take center 0, whose
    update turns NaN in both packages."""
    x, c, w = _edge(case)
    want_c, want_a = ref_km._lloyd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), 1)
    got_c, got_a = km._lloyd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c), 1)
    assert got_a.numpy().tolist() == np.asarray(want_a).tolist()
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(_EDGES))
def test_seed_steps_match_reference_at_the_kernels_edges(case):
    """Three k-means++ steps: mind, the min over the chosen centers of the
    reference's distances (NaN propagating), and p = mind * w with
    non-finite values 0, to 1e-5 of |x|^2 + |c|^2 (both expansions lie
    within 8 ulps of it)."""
    x, c, w = _edge(case)
    mind = torch.full((x.shape[0],), float("inf"))
    for j in range(3):
        p = kops.seed_step(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c[j]),
                           mind)
        want_m = np.asarray(ref_km._sq_dists(jnp.asarray(x), jnp.asarray(c[:j + 1]))).min(1)
        want_p = want_m * w
        want_p[~np.isfinite(want_p)] = 0.0
        scale = (x.astype(np.float64) ** 2).sum(1) + (c[j].astype(np.float64) ** 2).sum()
        got_m = mind.numpy()
        assert np.array_equal(np.isnan(got_m), np.isnan(want_m))
        live = ~np.isnan(want_m)
        assert np.all(np.abs(got_m - want_m)[live] <= 1e-5 * scale[live])
        assert np.all(np.isfinite(p.numpy()))
        assert np.all(np.abs(p.numpy() - want_p)[live] <= 1e-5 * (scale * w)[live])
        assert np.all(p.numpy()[~live] == 0.0)


def test_lloyd_scratch_is_kept_per_stream_and_grows():
    dev = torch.device("cpu")
    kops._SCRATCH.clear()
    f64, tk = kops.lloyd_scratch(dev, 7, 100, 3)
    assert f64.dtype == torch.float64 and f64.numel() == 100
    assert tk.dtype == torch.int32 and tk.tolist() == [0, 0, 0]
    assert kops.lloyd_scratch(dev, 7, 50, 2)[0] is f64  # long enough: the same pair
    other = kops.lloyd_scratch(dev, 8, 50, 2)  # another stream: its own pair
    assert other[0] is not f64 and other[1] is not tk
    grown, tk2 = kops.lloyd_scratch(dev, 7, 200, 2)
    assert grown.numel() == 200 and tk2.numel() == 3 and int(tk2.abs().sum()) == 0
    assert kops.lloyd_scratch(dev, 7, 10, 1)[0] is grown
    kops._SCRATCH.clear()


# ------------------------------------------------------------ with JAX's draws


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_choice_matches_jax_choice(n):
    rng = np.random.default_rng(n)
    p = rng.random(n).astype(np.float32)
    p[rng.random(n) < 0.3] = 0.0
    p = p / p.sum() if p.sum() > 0 else np.full(n, 1.0 / n, np.float32)
    key = jax.random.PRNGKey(n)
    want = np.asarray(jax.random.choice(key, n, shape=(64,), replace=True, p=jnp.asarray(p)))
    u = np.array(jax.random.uniform(key, (64,), dtype=jnp.float32))
    got = km._choice(torch.from_numpy(p), torch.from_numpy(u)).numpy()
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("seed,k,weighted", [(0, 1, False), (3, 5, True), (11, 8, False)])
def test_plusplus_init_picks_the_reference_centers(jax_draws, seed, k, weighted):
    jax_draws(k)
    x, w = _data(seed, weighted=weighted)
    want = np.asarray(ref_km._plusplus_init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                            jnp.asarray(w), k))
    got = km._plusplus_init(km._generator(seed, torch.device(CPU)), torch.from_numpy(x),
                            torch.from_numpy(w), k).numpy()
    assert np.array_equal(got, want)  # the same rows of x


def test_lloyd_from_the_reference_seeded_centers():
    x, w = _data(5)
    c0 = np.asarray(ref_km._plusplus_init(jax.random.PRNGKey(5), jnp.asarray(x),
                                          jnp.asarray(w), 5))
    want_c, want_a = ref_km._lloyd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c0), 10)
    got_c, got_a = km._lloyd(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(c0.copy()), 10)
    assert got_a.numpy().tolist() == np.asarray(want_a).tolist()
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_fit_matches_reference(jax_draws, weighted):
    jax_draws(5)
    x, w = _data(7, weighted=weighted)
    kw = {"weights": w} if weighted else {}
    want_c, want_a = ref_km.kmeans_fit(x, 5, seed=3, **kw)
    got_c, got_a = kmeans_fit(x, 5, seed=3, device=CPU, **kw)
    assert got_a.tolist() == np.asarray(want_a).tolist()
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-5)


def test_kmeans_fit_rejects_bad_k():
    x, _w = _data(1, n=10)
    for k in (0, 11):
        with pytest.raises(ValueError, match="out of range"):
            kmeans_fit(x, k, device=CPU)


@pytest.mark.parametrize("m,k", [(64, 4), (300, 4), (5000, 4)])
def test_kmeans_coreset_matches_reference(jax_draws, m, k):
    jax_draws(k)
    x, w = _data(8)
    want_p, want_w = ref_coreset(x, w, m, k=k, seed=7)
    got_p, got_w = kmeans_coreset(x, w, m, k=k, seed=7, device=CPU)
    assert got_p.dtype == np.float32 and got_w.dtype == np.float32
    assert np.array_equal(got_p, want_p)  # the same sampled rows
    np.testing.assert_allclose(got_w, want_w, rtol=2e-4)


def test_coreset_tree_update_and_query_match_reference(jax_draws):
    jax_draws(4)
    ref, port = RefTree(m=128, k=4, seed=6), CoresetTree(m=128, k=4, seed=6, device=CPU)
    for i, size in enumerate((500, 500, 100, 500, 60, 500)):
        batch, _w = _data(30 + i, n=size, k=4, weighted=False)
        ref.update(batch)
        port.update(batch)
        assert port.n_seen == ref.n_seen
        assert sorted(port._levels) == sorted(ref._levels)
        for lv in ref._levels:
            assert np.array_equal(port._levels[lv][0], ref._levels[lv][0])
            np.testing.assert_allclose(port._levels[lv][1], ref._levels[lv][1], rtol=2e-4)
    want_p, want_w = ref.query()
    got_p, got_w = port.query()
    assert np.array_equal(got_p, want_p)
    np.testing.assert_allclose(got_w, want_w, rtol=2e-4)


def test_coreset_tree_from_numpy_continues_the_reference_stream(jax_draws):
    jax_draws(3)
    ref = RefTree(m=64, k=3, seed=2)
    for i in range(3):
        ref.update(_data(40 + i, n=150, k=3, weighted=False)[0])
    port = interop.coreset_tree_from_numpy(64, 3, 2, ref._levels, ref.n_seen, device=CPU)
    batch = _data(43, n=150, k=3, weighted=False)[0]
    ref.update(batch)
    port.update(batch)
    assert port.n_seen == ref.n_seen
    want_p, want_w = ref.query()
    got_p, got_w = port.query()
    assert np.array_equal(got_p, want_p)
    np.testing.assert_allclose(got_w, want_w, rtol=2e-4)


def test_kmeans_transform_and_inertia_from_reference_model():
    x, w = _data(12)
    ref = RefKMeans(k=5, max_iters=10, seed=4).fit(x, weights=w)
    port = interop.kmeans_from_numpy(5, 10, 4, ref.centers, device=CPU)
    q, _ = _data(13, n=400)
    assert port.transform(q).tolist() == ref.transform(q).tolist()
    np.testing.assert_allclose(port.inertia(q), ref.inertia(q), rtol=1e-5)
    qw = np.random.default_rng(1).random(400).astype(np.float32)
    np.testing.assert_allclose(port.inertia(q, qw), ref.inertia(q, qw), rtol=1e-5)


def test_kmeans_from_numpy_checks_shape():
    from pixie_tpu_torch.status import InvalidArgument

    with pytest.raises(InvalidArgument):
        interop.kmeans_from_numpy(3, 10, 0, np.zeros((2, 4)))


# ------------------------------------ the port's own generator: recovery
# (the criteria of tests/test_ml.py)


def test_kmeans_recovers_separated_blobs():
    rng = np.random.default_rng(0)
    true = [(0.0, 0.0), (10.0, 0.0), (0.0, 10.0), (10.0, 10.0)]
    x = _blobs(rng, true, 200)
    centers, assign = kmeans_fit(x, 4, max_iters=20, seed=1, device=CPU)
    assert centers.shape == (4, 2)
    for t in true:
        d = np.min(np.linalg.norm(centers - np.asarray(t), axis=1))
        assert d < 0.5, f"center {t} not recovered (nearest {d})"
    for row in assign.reshape(4, 200):
        _vals, counts = np.unique(row, return_counts=True)
        assert counts.max() >= 195


def test_kmeans_weighted():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 0.05, (50, 1)), rng.normal(5, 0.05, (50, 1))])
    w = np.concatenate([np.full(50, 100.0), np.full(50, 1.0)])
    model = KMeans(k=2, max_iters=15, seed=2, device=CPU).fit(x, weights=w)
    np.testing.assert_allclose(np.sort(model.centers.ravel()), [0.0, 5.0], atol=0.2)
    labels = model.transform(np.array([[0.1], [4.9]]))
    assert labels[0] != labels[1]


def test_coreset_preserves_kmeans_cost():
    rng = np.random.default_rng(2)
    true = [(0.0, 0.0), (20.0, 0.0), (0.0, 20.0)]
    x = _blobs(rng, true, 2000, scale=0.5)
    cp, cw = kmeans_coreset(x, np.ones(len(x)), m=300, k=3, seed=3, device=CPU)
    assert len(cp) == 300
    assert abs(cw.sum() - len(x)) / len(x) < 0.35
    centers, _ = kmeans_fit(cp, 3, weights=cw, max_iters=20, seed=4, device=CPU)
    for t in true:
        assert np.min(np.linalg.norm(centers - np.asarray(t), axis=1)) < 1.5


def test_coreset_tree_streaming():
    rng = np.random.default_rng(5)
    tree = CoresetTree(m=256, k=4, seed=6, device=CPU)
    true = [(0.0, 0.0), (30.0, 0.0)]
    for _batch in range(8):
        tree.update(_blobs(rng, true, 500, scale=0.3))
    assert tree.n_seen == 8 * 1000
    pts, w = tree.query()
    assert len(pts) <= 256
    centers, _ = kmeans_fit(pts, 2, weights=w, max_iters=20, seed=7, device=CPU)
    for t in true:
        assert np.min(np.linalg.norm(centers - np.asarray(t), axis=1)) < 2.0


def test_fit_is_deterministic_for_a_seed():
    x, w = _data(21)
    a = kmeans_fit(x, 5, weights=w, seed=9, device=CPU)
    b = kmeans_fit(x, 5, weights=w, seed=9, device=CPU)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    x, w = _data(1, n=50)
    with pytest.raises(Unavailable, match="CUDA"):
        kmeans_fit(x, 2)
    with pytest.raises(Unavailable, match="CUDA"):
        kmeans_coreset(x, w, 10, k=2)
    with pytest.raises(Unavailable, match="CUDA"):
        KMeans(k=2, centers=x[:2]).transform(x)


# ------------------------------------------------------------ request paths

PATHS = ([f"/api/v1/products/sku-{i}" for i in range(50)]
         + ["/api/v1/cart", "/healthz", "/u/123", "/u/456/items?x=1",
            "/orders/550e8400-e29b-41d4-a716-446655440000/items",
            "/a/deadbeef01/b", "", "/"]
         + [f"/svc/{s}/op" for s in "abcdefghij"])


@pytest.mark.parametrize("path", PATHS[48:])
def test_templatize_matches_reference(path):
    assert templatize(path) == ref_templatize(path)


@pytest.mark.parametrize("branch_limit", [2, 8, 100])
def test_request_path_clustering_matches_reference(branch_limit):
    got = RequestPathClustering(branch_limit=branch_limit).fit(PATHS + [None])
    want = RefRPC(branch_limit=branch_limit).fit(PATHS + [None])
    assert got.templates == want.templates
    for p in PATHS + ["/api/v1/products/sku-99", "/svc/z/op", "/nowhere"]:
        assert got.predict(p) == want.predict(p)


def test_request_path_clustering_generalizes_varying_segment():
    c = RequestPathClustering(branch_limit=8).fit(PATHS[:52])
    assert "/api/v1/products/*" in c.templates
    assert c.predict("/api/v1/products/sku-99") == "/api/v1/products/*"
    assert c.predict("/healthz") == "/healthz"


@pytest.mark.parametrize("module", ["pixie_tpu_torch.ml", "pixie_tpu_torch.ml.fit",
                                    "pixie_tpu_torch.ml.request_path",
                                    "pixie_tpu_torch.ml.coreset"])
def test_ml_modules_import_first(module):
    """Each ml module imports in a fresh process before anything else of the
    package, and the fit UDAs are then in the registry."""
    import pathlib
    import subprocess
    import sys

    code = (f"import {module}\n"
            "from pixie_tpu_torch.udf import registry\n"
            "assert type(registry.uda('_kmeans_fit')).__name__ == 'KMeansFitUDA'\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=pathlib.Path(__file__).resolve().parent.parent, timeout=120)
    assert out.returncode == 0, out.stderr
