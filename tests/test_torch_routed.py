"""The routed slice of the port (K4 and RoutedSplitIndex, search and clustered
build) against the JAX package, on the CPU.

Bit for bit where every input is exact: the K4 twin against
``routed_classmax_scan(..., interpret=True)`` and against the XLA emulation
of ``scan_select`` on integer tables; the routing, the capacity assignment,
the cluster-major order, the knob rules, the cost counters and the
checkpoints. By a stated tolerance where float sums differ between XLA and
torch: the twin on Gaussian tables, the k-means, the planned clusters and
the search. The port's random draws are ``torch.Generator`` ones, so the
build is held to the JAX build with JAX's draws injected, or by recall.
On the CPU the port's wrapper runs its plain twin; the CUDA kernel is held
against the twin in tests/test_torch_kernel.py, on a card. Every build here
runs on one thread of the native code and nothing depends on timing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.io import checkpoint as jc
from shine_tpu.models import ivf as jivf
from shine_tpu.models import routed_split as jrs
from shine_tpu.ops import pallas_scan_routed as jk
from shine_tpu.parallel import placement as jpl
from shine_tpu_torch import RoutedSplitIndex, build_routed_split, routed_split_from_jax
from shine_tpu_torch.io import (
    brute_force_knn,
    load_routed_split,
    recall_at_k,
    save_routed_split,
)
from shine_tpu_torch.models import ivf as tivf
from shine_tpu_torch.models import routed_split as trs
from shine_tpu_torch.ops import scan_routed as tk
from shine_tpu_torch.ops.regen import make_rowfn
from shine_tpu_torch.ops.scan_split import NEG, pack_split_query
from shine_tpu_torch.parallel import placement as tpl

N, D, NQ = 16_384, 32, 128
BUILD = dict(cap_target=512, cls=128, train_size=8192, seed=3)  # cap 512, C 34
# Gaussian split scores (|score| up to ~1e2) from 32 products, each exact in
# f32, summed in another order, then scaled and shifted: a few f32 ulps
GAUSS_ATOL = 1e-4
# re-ranked L2 distances (~10-100, from terms up to ~2e3) summed in other
# orders by XLA and torch: a few ulps of the largest term, relative
DIST_RTOL = 1e-4
MIN_OVERLAP = 0.99
# the search routes: the auto knobs (C=34: every cluster granted), T=32
# with a partial grant, and a starved grant whose spill runs T=16 tiles
ROUTES = {
    "auto": {},
    "tile32": {"probes": 8, "tile": 32, "shared": 16},
    "starved": {"probes": 8, "tile": 64, "shared": 10, "fallback": 0.6},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU products on one thread here, whatever the machine: the
    order of their f32 sums then does not follow the core count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_base():
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(32, D)) * 4.0
    base = (centers[rng.integers(0, 32, N)] + rng.normal(size=(N, D))).astype(np.float32)
    queries = (centers[rng.integers(0, 32, NQ)]
               + rng.normal(size=(NQ, D)) * 0.5).astype(np.float32)
    gt, _ = brute_force_knn(base, queries, 10)
    return base, queries, gt


@pytest.fixture(scope="module")
def jax_idx(small_base):
    return jrs.build_routed_split(N, D, base_dev=jnp.asarray(small_base[0]), **BUILD)


@pytest.fixture(scope="module")
def port_idx(small_base):
    return build_routed_split(N, D, base_dev=torch.from_numpy(small_base[0]), **BUILD)


def _jax_arrays(idx, base):
    return {"centroids": np.asarray(idx.centroids), "comp": np.asarray(idx.comp),
            "aux_r": np.asarray(idx.aux_r), "gid": np.asarray(idx.gid),
            "base": base, "sqnorms": np.asarray(idx.sqnorms)}


def _carried(jax_idx, base):
    return routed_split_from_jax(_jax_arrays(jax_idx, base), n=N, dim=D,
                                 metric="l2", cls=jax_idx.cls, cap=jax_idx.cap,
                                 device="cpu")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# --- K4: the twin against the interpret-mode kernel and the XLA emulation ----

def _int_rows(rng, n, d):
    """Integer rows whose largest magnitude is 127 (column 0): int8 holds them
    exactly, with scl 2 (L2) or 1 (IP), and every score is an exact f32
    integer, ties and all."""
    v = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    v[:, 0] = np.where(rng.random(n) < 0.5, -127.0, 127.0)
    return v


def _k4_case(rng, comp_dtype, metric, T, integer=True, C=6, cap=256, cls=128, G=3, P=4):
    """Clustered split tables of C clusters (a few empty slots) plus the pad
    cluster, G*T queries and a (G, P) column table that names the pad
    cluster once."""
    n = C * cap - 37
    v = _int_rows(rng, n, D) if integer else rng.normal(size=(n, D)).astype(np.float32)
    gid = np.full((C + 1) * cap, -1, np.int32)
    slots = np.sort(rng.choice(C * cap, n, replace=False))
    gid[slots] = rng.permutation(n).astype(np.int32)
    comp, aux_r = trs.pack_clustered(torch.from_numpy(v), torch.from_numpy(gid), metric,
                                     cap=cap, cls=cls, comp_dtype=comp_dtype)
    qv = (rng.integers(-4, 5, size=(G * T, D)).astype(np.float32) if integer
          else rng.normal(size=(G * T, D)).astype(np.float32))
    cols = np.stack([rng.choice(C + 1, P, replace=False) for _ in range(G)]).astype(np.int32)
    cols[0, -1] = C
    return comp, aux_r, torch.from_numpy(gid), qv, torch.from_numpy(cols), cap, cls


def _jnp(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("T", [16, 32, 64])
@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("comp_dtype", ["int8", "bf16"])
def test_k4_twin_matches_pallas_and_xla_bit_for_bit(comp_dtype, metric, T):
    rng = np.random.default_rng(T + 3 * metric)
    comp, aux_r, gid, qv, cols, cap, cls = _k4_case(rng, comp_dtype, metric, T)
    q = pack_split_query(torch.from_numpy(qv), comp.shape[1])
    before = dict(tk.routed_classmax_scan.form_launches)
    best, rows = tk.routed_classmax_scan(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)
    assert tk.routed_classmax_scan.form_launches == before  # the twin ran
    want_b, want_r = jk.routed_classmax_scan(_jnp(comp), _jnp(aux_r), _jnp(q), _jnp(cols),
                                             T=T, cap=cap, cls=cls, interpret=True)
    np.testing.assert_array_equal(_bits(best.numpy()), _bits(want_b))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_r))
    # the select on top: ids bit for bit against the XLA emulation and the
    # interpret-mode kernel, with many repeated best values
    C = aux_r.shape[0] - 1
    got = trs.scan_select(comp, aux_r, gid, torch.from_numpy(qv), cols, T=T, cap=cap,
                          cls=cls, kk=24).numpy()
    for engine in ("xla", "interpret"):
        want = jrs.scan_select(_jnp(comp), _jnp(aux_r), _jnp(gid), jnp.asarray(qv),
                               _jnp(cols), C=C, T=T, cap=cap, cls=cls, kk=24,
                               engine=engine)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("comp_dtype", ["int8", "bf16"])
def test_k4_twin_on_gaussian_tables(comp_dtype):
    rng = np.random.default_rng(11)
    comp, aux_r, _, qv, cols, cap, cls = _k4_case(rng, comp_dtype, 0, 32, integer=False)
    q = pack_split_query(torch.from_numpy(qv), comp.shape[1])
    best, rows = tk.routed_classmax_scan(comp, aux_r, q, cols, T=32, cap=cap, cls=cls)
    want_b, want_r = jk.routed_classmax_scan(_jnp(comp), _jnp(aux_r), _jnp(q), _jnp(cols),
                                             T=32, cap=cap, cls=cls, interpret=True)
    np.testing.assert_allclose(best.numpy(), np.asarray(want_b), rtol=0, atol=GAUSS_ATOL)
    # rows agree where no other code of the lane comes within the tolerance
    sc = []
    for g in range(cols.shape[0]):
        blk = comp[: aux_r.shape[0] * cap].view(-1, cap, comp.shape[1])[cols[g].long()]
        dots = q[g * 32:(g + 1) * 32].float() @ blk.reshape(-1, comp.shape[1]).float().T
        a = aux_r[cols[g].long()]
        m = cap // cls
        sc.append(dots.view(32, -1, cls) * a[:, m:].reshape(-1, cls)
                  + a[:, :m].reshape(-1, cls))
    top2 = torch.topk(torch.cat(sc), 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1] > GAUSS_ATOL).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(rows.numpy()[clear], np.asarray(want_r)[clear])


def test_aux_routed_layout_matches_jax():
    rng = np.random.default_rng(5)
    C, cap, cls = 6, 512, 128
    flat = rng.normal(size=(2, C * cap)).astype(np.float32)
    want = np.asarray(jk.aux_routed_layout(jnp.asarray(flat), C, cap, cls))
    got = tk.aux_routed_layout(torch.from_numpy(flat), C, cap, cls).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for lo in range(0, C * cap, 2 * cap):
        piece = flat[:, lo:lo + 2 * cap]
        want = np.asarray(jk.aux_routed_layout_chunk(jnp.asarray(piece), cap, cls))
        got = tk.aux_routed_layout_chunk(torch.from_numpy(piece), cap, cls).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_top_k_matches_lax_top_k_on_zeros_and_repeats():
    """The routed select follows ``lax.top_k``: +0.0 above -0.0, the lower
    lane first among equal values (``select_lanes`` ties the two zeros)."""
    rng = np.random.default_rng(2)
    vals = np.array([-1.0, -0.0, 0.0, 1.0, 2.0, NEG], np.float32)
    x = vals[rng.integers(0, len(vals), size=(16, 64))]
    for kk in (1, 8, 64):
        got_v, got_i = trs.top_k(torch.from_numpy(x), kk)
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), kk)
        np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("bad", ["cols_range", "groups", "aux_shape", "short_comp",
                                 "width", "dtype", "cap", "pad_row", "pad_nrm"])
def test_k4_rejects_what_it_cannot_take(bad):
    rng = np.random.default_rng(1)
    comp, aux_r, _, qv, cols, cap, cls = _k4_case(rng, "int8", 0, 16)
    q = pack_split_query(torch.from_numpy(qv), comp.shape[1])
    T = 16
    if bad == "cols_range":
        cols[1, 0] = aux_r.shape[0]
    elif bad == "groups":
        T = 15
    elif bad == "aux_shape":
        aux_r = aux_r[:, :2].contiguous()
    elif bad == "short_comp":
        comp = comp[:-cap]
    elif bad == "width":
        q = q[:, :16].contiguous()
    elif bad == "dtype":
        comp = comp.to(torch.float16)
    elif bad == "cap":
        cap = cap + 64
    elif bad == "pad_row":  # the pad cluster, which the kernel skips, holds a row
        comp[-cap, 1] = 1
    elif bad == "pad_nrm":
        aux_r[-1, 0, 5] = 0.0
    with pytest.raises((TypeError, ValueError)):
        tk.routed_classmax_scan(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)


# --- the integer stages, on identical inputs ---------------------------------

@pytest.mark.parametrize("G,T,p,C,P", [(3, 16, 4, 40, 24), (2, 64, 8, 34, 34),
                                       (4, 32, 8, 300, 48), (2, 16, 3, 10, 10)])
def test_route_cols_matches_jax(G, T, p, C, P):
    rng = np.random.default_rng(G * T + C)
    # wishes near a few centres per tile, so that tiles share and overflow
    probes = np.stack([
        np.stack([(rng.integers(0, C) + rng.choice(min(C, 3 * p), p, replace=False)) % C
                  for _ in range(T)]) for _ in range(G)]).astype(np.int32)
    cols, cov, qg = tivf._route_cols(torch.from_numpy(probes), C, P)
    w_cols, w_cov, w_qg = jrs._route_cols(jnp.asarray(probes), C, P)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(w_cols))
    np.testing.assert_array_equal(_bits(cov.numpy()), _bits(np.asarray(w_cov)))
    np.testing.assert_array_equal(_bits(qg.numpy()), _bits(np.asarray(w_qg)))


@pytest.mark.parametrize("defer_residue", [False, True])
@pytest.mark.parametrize("room", ["scalar", "per_cluster"])
def test_capacity_assign_matches_jax(defer_residue, room):
    rng = np.random.default_rng(7 + defer_residue)
    n, R, C = 5000, 4, 40
    choice = np.stack([rng.choice(C, R, replace=False) for _ in range(n)]).astype(np.int32)
    # repeated distances, so that the (distance, cluster) order has ties
    choice_d = np.sort(rng.integers(0, 50, size=(n, R)), axis=1).astype(np.float32)
    # room for every row in all, too little for every row's R choices
    cap = 130 if room == "scalar" else rng.integers(90, 170, size=C)
    if room == "per_cluster":
        cap[0] += max(0, n - int(cap.sum()))
    # integer rows and centres: the residue's distances are exact
    v32 = rng.integers(-5, 6, size=(n, 8)).astype(np.float32)
    cents = rng.integers(-5, 6, size=(C, 8)).astype(np.float32)
    want = jivf._capacity_assign_host(choice, choice_d, C, cap, v32, cents,
                                      defer_residue=defer_residue)
    got = tivf._capacity_assign_host(choice, choice_d, C, cap, v32, cents,
                                     defer_residue=defer_residue)
    np.testing.assert_array_equal(got, want)
    assert (want < 0).any() == defer_residue  # the residue path was taken


def test_cluster_major_order_matches_jax_gid(jax_idx):
    """Given the JAX build's assignment, the port lays the rows out exactly
    as the JAX build did (gid bit for bit)."""
    C, cap = jax_idx.C, jax_idx.cap
    gid = np.asarray(jax_idx.gid)[: (C + 1) * cap]
    pos = np.nonzero(gid >= 0)[0]
    assign = np.empty(N, np.int64)
    assign[gid[pos]] = pos // cap
    np.testing.assert_array_equal(trs._cluster_major_order(assign, C, cap), gid)


def test_knob_rules_match_jax():
    for C in (2, 34, 1075, 4095, 4096, 10754, 25805, 200_000):
        assert trs._auto_probes(C) == jrs._auto_probes(C)
        for probes in (1, 8, 32, 128):
            for tile in (0, 16, 32):
                for shared in (0, 4, 300):
                    assert (trs._auto_knobs(C, probes, tile, shared)
                            == jrs._auto_knobs(C, probes, tile, shared))
            for n_need in (0, 1, 63, 64, 65, 3000):
                assert trs._spill_plan(n_need, probes, C) == jrs._spill_plan(n_need, probes, C)


@pytest.mark.parametrize("knobs", [{}, {"probes": 16, "tile": 64},
                                   {"probes": 8, "shared": 4, "tile": 32}])
def test_cost_counters_match_jax(small_base, jax_idx, knobs):
    idx = _carried(jax_idx, small_base[0])
    # the JAX method's formula applied to the port's index (its own width)
    assert idx.cost_counters(256, **knobs) == jrs.RoutedSplitIndex.cost_counters(
        idx, 256, **knobs)
    assert idx.cost_counters(256, **knobs)["scanned_rows"] == jax_idx.cost_counters(
        256, **knobs)["scanned_rows"]


def test_checkpoint_jax_to_port(tmp_path, small_base, jax_idx):
    path = str(tmp_path / "jax.npz")
    jc.save_routed_split(jax_idx, path)
    idx = load_routed_split(path, base_dev=torch.from_numpy(small_base[0]))
    assert (idx.C, idx.cap, idx.cls, idx.n, idx.dim) == (jax_idx.C, jax_idx.cap,
                                                         jax_idx.cls, N, D)
    jcomp = np.asarray(jax_idx.comp)
    np.testing.assert_array_equal(idx.comp.numpy(), jcomp[:, :D])
    assert not jcomp[:, D:].any()  # the JAX package's zero lane padding
    for name in ("aux_r", "gid", "centroids"):
        np.testing.assert_array_equal(_bits(getattr(idx, name).numpy()),
                                      _bits(np.asarray(getattr(jax_idx, name))))


@pytest.mark.parametrize("comp_dtype", ["int8", "bf16"])
def test_checkpoint_port_to_jax(tmp_path, small_base, comp_dtype):
    base = small_base[0]
    idx = build_routed_split(N, D, base_dev=torch.from_numpy(base), comp_dtype=comp_dtype,
                             kmeans_iters=4, **BUILD)
    path = str(tmp_path / "port.npz")
    save_routed_split(idx, path)
    back = jc.load_routed_split(path, base_dev=jnp.asarray(base))
    assert (back.C, back.cap, back.cls) == (idx.C, idx.cap, idx.cls)
    if comp_dtype == "bf16":
        np.testing.assert_array_equal(np.asarray(back.comp).view(np.uint16),
                                      idx.comp.view(torch.int16).numpy().view(np.uint16))
    else:
        np.testing.assert_array_equal(np.asarray(back.comp), idx.comp.numpy())
    for name in ("aux_r", "gid", "centroids"):
        np.testing.assert_array_equal(_bits(np.asarray(getattr(back, name))),
                                      _bits(getattr(idx, name).numpy()))
    # and the JAX package serves the port's tables
    ids, _ = back.search(small_base[1], 10, engine="xla", batch_size=NQ)
    assert recall_at_k(ids, small_base[2], 10) >= 0.97


# --- the float stages, by tolerance --------------------------------------------

def _train_sample(base, ts=8192, seed=3):
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (ts,), 0, N,
                                        dtype=jnp.int32))
    return base[ids]


def _jax_init_ids(n, k, seed):
    return torch.from_numpy(np.asarray(
        jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False)).astype(np.int64))


def _inertia(points, cents):
    d = ((points[:, None, :].astype(np.float64) - cents[None].astype(np.float64)) ** 2).sum(-1)
    return d.min(axis=1).sum()


def test_lloyd_step_matches_jax(small_base, monkeypatch):
    """One Lloyd step from identical centroids: >= 99.9% of the
    assignments equal, centroids within 1e-4 (means of ~240 rows whose f32
    sums differ by ulps)."""
    x = _train_sample(small_base[0])
    k, seed = 34, 3
    monkeypatch.setattr(tivf, "_draw_init_ids", _jax_init_ids)
    got = tivf._lloyd_chunked(torch.from_numpy(x), k=k, iters=1, seed=seed).numpy()
    want = np.asarray(jivf._lloyd_chunked(jnp.asarray(x), k=k, iters=1, seed=seed))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    cents = x[_jax_init_ids(len(x), k, seed).numpy()]
    a = tivf._nearest_r_chunk(torch.from_numpy(x), torch.from_numpy(cents),
                              torch.from_numpy((cents * cents).sum(1)), R=1)[0].numpy()
    w = np.asarray(jivf._nearest_r_chunk(jnp.asarray(x), jnp.asarray(cents),
                                         jnp.sum(jnp.asarray(cents) ** 2, 1), R=1)[0])
    assert (a == w).mean() >= 0.999


def test_kmeans_matches_jax_with_its_draws(small_base, monkeypatch):
    """Whole k-means runs from the JAX draws: inertia within 0.5%."""
    x = _train_sample(small_base[0])
    monkeypatch.setattr(tivf, "_draw_init_ids", _jax_init_ids)
    got = tivf._lloyd_chunked(torch.from_numpy(x), k=34, iters=20, seed=3).numpy()
    want = np.asarray(jivf._lloyd_chunked(jnp.asarray(x), k=34, iters=20, seed=3))
    assert abs(_inertia(x, got) / _inertia(x, want) - 1) < 5e-3
    monkeypatch.setattr(tpl, "_draw_first", lambda n, seed: int(
        jax.random.randint(jax.random.PRNGKey(seed), (), 0, n)))
    pts = np.array(want)  # the placement k-means runs over centroids in the build
    got, _ = tpl._lloyd(torch.from_numpy(pts), k=4, iters=15, seed=3)
    want2, _ = jpl._lloyd(jnp.asarray(pts), k=4, iters=15, seed=3)
    assert abs(_inertia(pts, got.numpy()) / _inertia(pts, np.asarray(want2)) - 1) < 5e-3


def test_plan_routed_matches_jax_with_its_draws(small_base, monkeypatch):
    """The port's plan with the JAX draws injected puts >= 99% of the rows
    in the same cluster as the JAX plan (clusters matched by centroid, so
    a relabelling alone would not fail it)."""
    base = small_base[0]
    monkeypatch.setattr(trs, "_draw_train_ids", lambda n, ts, seed: torch.from_numpy(
        np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (ts,), 0, n,
                                      dtype=jnp.int32)).astype(np.int64)))
    monkeypatch.setattr(tivf, "_draw_init_ids", _jax_init_ids)
    monkeypatch.setattr(tpl, "_draw_first", lambda n, seed: int(
        jax.random.randint(jax.random.PRNGKey(seed), (), 0, n)))
    kw = dict(cap_target=512, cls=128, cap_slack=1.05, train_size=8192,
              kmeans_iters=20, seed=3, say=lambda *_: None)
    base_j = jnp.asarray(base)
    w_cents, w_order, C, cap, _ = jrs._plan_routed(
        N, D, rowfn=lambda ids: base_j[ids], shards=1, achunk=262_144, **kw)
    cents, order, C2, cap2 = trs._plan_routed(
        N, D, rowfn=make_rowfn(None, torch.from_numpy(base), 0), **kw)
    assert (C2, cap2) == (C, cap)

    def assign_of(o):
        pos = np.nonzero(o >= 0)[0]
        a = np.empty(N, np.int64)
        a[o[pos]] = pos // cap
        return a

    w_cents = np.asarray(w_cents)
    match = ((cents.numpy()[:, None] - w_cents[None]) ** 2).sum(-1).argmin(1)
    assert (match[assign_of(order)] == assign_of(np.asarray(w_order))).mean() >= 0.99


@pytest.mark.parametrize("carrier", ["convert", "checkpoint"])
def test_search_on_jax_index(tmp_path, small_base, jax_idx, carrier):
    """The port serves a JAX-built index like the JAX package on every
    route: id overlap >= 0.99, distances within 1e-4 relative, coverage
    within 0.01, the same number of spilled queries."""
    base, queries, _ = small_base
    if carrier == "convert":
        idx = _carried(jax_idx, base)
    else:
        path = str(tmp_path / "jax.npz")
        jc.save_routed_split(jax_idx, path)
        idx = load_routed_split(path, base_dev=torch.from_numpy(base))
    for route, knobs in ROUTES.items():
        want_i, want_d = jax_idx.search(queries, 10, engine="xla", batch_size=NQ, **knobs)
        got_i, got_d = idx.search(queries, 10, batch_size=NQ, **knobs)
        assert recall_at_k(got_i, want_i, 10) >= MIN_OVERLAP, route
        same = got_i == want_i
        np.testing.assert_allclose(got_d[same], want_d[same], rtol=DIST_RTOL, atol=0)
        assert abs(idx.last_coverage - jax_idx.last_coverage) <= 0.01, route
        assert idx.last_fallback == jax_idx.last_fallback, route
        if route == "starved":
            assert 0 < idx.last_fallback < NQ and idx.last_coverage < 0.9


def test_port_build_recall_matches_jax_build(small_base, jax_idx, port_idx):
    """Built with its own draws, the port's index serves the recall of the
    JAX build at the same knobs, within 0.01."""
    base, queries, gt = small_base
    for knobs in ROUTES.values():
        want, _ = jax_idx.search(queries, 10, engine="xla", batch_size=NQ, **knobs)
        got, _ = port_idx.search(queries, 10, batch_size=NQ, **knobs)
        assert abs(recall_at_k(got, gt, 10) - recall_at_k(want, gt, 10)) <= 0.01
        assert recall_at_k(got, gt, 10) >= 0.93


def test_fold_gt_stream_matches_jax(small_base):
    base, queries, gt = small_base
    got = trs.fold_gt_stream(make_rowfn(None, torch.from_numpy(base), 0), N, queries, 0,
                             rchunk=5000)
    base_j = jnp.asarray(base)
    want = jrs.fold_gt_stream(lambda ids: base_j[ids], N, queries, 0, rchunk=4096)
    assert (got == want).mean() >= 0.99 and (got == gt).mean() >= 0.99


# --- the port on its own -----------------------------------------------------

def test_gid_is_a_permutation_and_pad_rows_never_win(small_base, port_idx):
    idx = port_idx
    gid = idx.gid.numpy()
    np.testing.assert_array_equal(np.sort(gid[gid >= 0]), np.arange(N))
    assert gid.shape[0] == (idx.C + 1) * idx.cap
    assert (gid[idx.C * idx.cap:] == -1).all()  # the pad cluster
    m = idx.cap // idx.cls
    aux = idx.aux_r.numpy().reshape(idx.C + 1, 2, m, idx.cls).transpose(1, 0, 2, 3)
    assert (aux[0].reshape(-1)[gid < 0] == np.float32(NEG)).all()
    assert not idx.comp.numpy()[gid < 0].any()
    # every column granted: the pad rows of each cluster are scanned and
    # never surface
    ids, _ = idx.search(small_base[1], 10, probes=idx.C, shared=idx.C, batch_size=NQ)
    assert (ids >= 0).all()
    assert recall_at_k(ids, small_base[2], 10) >= 0.97


def test_ip_metric(small_base):
    base, queries, _ = small_base
    bn = base / (np.linalg.norm(base, axis=1, keepdims=True) + 1e-30)
    qn = queries / (np.linalg.norm(queries, axis=1, keepdims=True) + 1e-30)
    gt = np.argsort(-(qn @ bn.T), axis=1, kind="stable")[:, :10]
    idx = build_routed_split(N, D, base_dev=torch.from_numpy(bn), metric="ip",
                             cap_target=512, cls=128, train_size=8192, seed=6)
    ids, dists = idx.search(qn, 10, probes=8, shared=16, tile=32, kk=64, batch_size=NQ)
    assert recall_at_k(ids, gt, 10) >= 0.9
    assert (np.diff(dists, axis=1) >= -1e-5).all()


def test_recenter_routing_member_means(small_base):
    base, queries, gt = small_base
    idx = build_routed_split(N, D, base_dev=torch.from_numpy(base), kmeans_iters=4, **BUILD)
    idx.recenter_routing(chunk=1024)
    gid = idx.gid.numpy()
    for c in range(idx.C):
        members = gid[c * idx.cap:(c + 1) * idx.cap]
        members = members[members >= 0]
        if not len(members):
            continue
        np.testing.assert_allclose(idx.centroids[c].numpy(), base[members].mean(0),
                                   rtol=1e-4, atol=1e-4)
    ids, _ = idx.search(queries, 10, probes=8, batch_size=NQ, fallback=0)
    assert recall_at_k(ids, gt, 10) > 0.9


def test_build_with_queries_returns_exact_gt(small_base):
    base, queries, gt = small_base
    _, got = build_routed_split(N, D, base_dev=torch.from_numpy(base), kmeans_iters=2,
                                queries=queries, **BUILD)
    assert (got == gt).mean() >= 0.99


def test_entry_points_default_to_the_card(tmp_path, small_base, jax_idx):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the refusal path is not taken")
    arrays = _jax_arrays(jax_idx, small_base[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        routed_split_from_jax(arrays, n=N, dim=D, metric="l2", cls=jax_idx.cls)
    path = str(tmp_path / "jax.npz")
    jc.save_routed_split(jax_idx, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_routed_split(path)
    # a row-keyed index holds its row source and no base; without a card
    # its carrier refuses as the others do
    rs = (torch.tensor([0, 7]), torch.zeros(4, D))
    idx = RoutedSplitIndex(torch.zeros(2, D), torch.zeros(3, D), torch.zeros(3, 8, 1),
                           torch.zeros(3), 2, D, 0, cls=1, row_source=rs)
    assert idx.row_source is rs and idx.base_dev is None
    arrays.pop("base")
    with pytest.raises(RuntimeError, match="CUDA"):
        routed_split_from_jax(arrays, n=N, dim=D, metric="l2", cls=jax_idx.cls,
                              row_source=rs)
