"""The port's experiment scripts on the CPU against the JAX package, at
small sizes:

- ``scripts/torch_collect_results.py`` and the JAX collector, both as a
  user runs them, on the JAX package's sweep records: the same CSV bytes;
- ``scripts/torch_exp_sweep.py --device cpu``: two children on a 2-shard
  mesh (the replica on and off: equal recall, hit rate 0 and > 0, the CSV's
  header the JAX collector's columns); a failing child makes it exit 1;
- ``scripts/torch_latency_probe.py`` in process at 4,096 x 32 on one
  graph that both packages serve: the JAX probe's keys, p99 >= p50, and
  recall@10 at each batch equal to the JAX indexes' on the same queries
  (``RECALL_TOL``); ``utils/meter.py:p50_p99`` against ``bench.py``'s own
  ``measure_latency``;
- ``scripts/torch_exp_ici_exchange.py`` at 2,048 x 16, S=8, at two grid
  points on one ``threads=1`` graph: rounds, lanes and hit rate equal to the
  JAX ``ShardedIndex``'s on its 8 virtual devices, wire bytes within
  ``BYTES_RTOL``;
- ``scripts/torch_exp_routed_sharded.py`` at 8,192 x 32 and one P_loc: C,
  lanes, window, overflow and coverage equal to the JAX recipe's, recall
  within ``ROUTED_RECALL_GAP``; ``scripts/torch_exp_skew_capacity_mesh.py``
  at one alpha and P_loc on the same index: its Zipf stream the JAX
  script's, lanes, overflow and coverage equal to JAX's on it;
- ``scripts/torch_sustained_b_sweep.py``: the stream's length equal to the
  JAX script's formula, and one run at 2,048 x 32."""

import ast
import csv
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import load_scale_script
from shine_tpu.config import HNSWParams, SearchParams
from shine_tpu.graph import build_graph as j_build_graph
from shine_tpu.io import recall_at_k as j_recall_at_k
from shine_tpu.io import save_graph as j_save_graph
from shine_tpu.io import synthetic_dataset as j_synthetic_dataset
from shine_tpu.io.device_synth import regen_rows as j_regen_rows
from shine_tpu.io.skew import skewed_workload as j_skewed_workload
from shine_tpu.io.skew import zipf_ranks as j_zipf_ranks
from shine_tpu.models import HNSWIndex as JHNSWIndex
from shine_tpu.models.flat import FastFlatIndex as JFastFlatIndex
from shine_tpu.ops import distance as jd
from shine_tpu.ops import pallas_scan3 as j3
from shine_tpu.ops.pallas_scan import pack_ext_query as j_pack_ext_query
from shine_tpu.parallel import ShardedIndex as JShardedIndex
from shine_tpu.parallel import shard_mesh as j_shard_mesh
from shine_tpu.parallel.routed_sharded import build_routed_split_sharded as j_routed_build
from shine_tpu_torch.parallel import lane_study

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
CPU = torch.device("cpu")
RECALL_TOL = 0.0  # one graph, one table: the same ids (C5: integer work and f32 sums agree here)
BYTES_RTOL = 1e-6  # JAX's wire-byte counter is an f32 accumulator (tests/test_torch_sharded.py)
ROUTED_RECALL_GAP = 0.02  # the builds' k-means sums in other orders (ROADMAP C5, C12)


def _env() -> dict:
    return {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _script(name: str, *args: str, timeout: int = 300) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, os.path.join(SCRIPTS, name), *args], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=timeout)


def _jax_columns() -> list[str]:
    spec = importlib.util.spec_from_file_location(
        "jax_collect_results", os.path.join(SCRIPTS, "collect_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [c for c, _ in mod.COLUMNS]


def _same_csv(jsonl: str, tmp_path) -> bytes:
    """Both collectors on ``jsonl``; their CSV bytes, which must agree."""
    got = {}
    for name in ("collect_results.py", "torch_collect_results.py"):
        out = tmp_path / f"{name}.csv"
        res = _script(name, jsonl, "--out", str(out))
        assert res.returncode == 0, res.stderr
        got[name] = out.read_bytes()
    assert got["torch_collect_results.py"] == got["collect_results.py"]
    return got["collect_results.py"]


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- (a) the collector --------------------------------------------------------

@pytest.mark.parametrize("record", ["skew_budget.jsonl", "sweep_r2_sharded.jsonl"])
def test_collector_bytes_equal_jax(record, tmp_path):
    table = _same_csv(os.path.join(ROOT, "results", record), tmp_path)
    lines = table.decode().splitlines()
    with open(os.path.join(ROOT, "results", record)) as f:
        assert len(lines) == 1 + sum(1 for x in f if x.strip())
    assert lines[0].split(",") == _jax_columns()


# --- (b) the sweep script -----------------------------------------------------

SWEEP = ["--synthetic", "4096:16", "--index", "hnsw", "--shards", "2", "--zipf", "1.25",
         "--ef-search", "64", "--num-queries", "64", "--device", "cpu"]


def test_sweep_two_children(tmp_path):
    out = tmp_path / "sweep.jsonl"
    res = _script("torch_exp_sweep.py", "--out", str(out), *SWEEP,
                  "--cache-ratio", "0", "0.10", "--label", "t",
                  "--index-cache", str(tmp_path / "g.npz"), "--extra", "--batch", "64")
    assert res.returncode == 0, res.stderr
    docs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [d["meta"]["label"] for d in docs] == ["t:hnsw:nocache", "t:hnsw:cache0.1"]
    assert "--store-index" in res.stderr and "--load-index" in res.stderr
    for d in docs:
        assert d["meta"]["framework"] == "shine_tpu_torch" and d["meta"]["device"] == "cpu"
        assert (d["meta"]["num_shards"], d["meta"]["zipf"]) == (2, 1.25)
        assert d["queries"]["num_queries"] == 64 and "card" not in d["meta"]
    assert docs[0]["queries"]["recall"] == docs[1]["queries"]["recall"] > 0.9
    assert docs[0]["cache"]["hit_rate"] == 0 < docs[1]["cache"]["hit_rate"]
    table = _same_csv(str(out), tmp_path)
    rows = list(csv.reader(table.decode().splitlines()))
    assert rows[0] == _jax_columns() and len(rows) == 3


def test_sweep_exits_1_when_a_child_fails(tmp_path):
    out = tmp_path / "sweep.jsonl"
    res = _script("torch_exp_sweep.py", "--out", str(out), *SWEEP, "--extra",
                  "--no-such-flag")
    assert res.returncode == 1
    assert "failed" in res.stderr and not out.exists()


# --- (c) the latency probe ----------------------------------------------------

LAT = dict(n=4096, d=32, nq=512)


def _bench_measure_latency():
    """``bench.py``'s own ``measure_latency`` (nested in its main), compiled
    alone, and the fake clock it reads."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "measure_latency")
    clock = {"ticks": iter(())}

    class FakeTime:
        @staticmethod
        def perf_counter():
            return next(clock["ticks"])

    ns = {"time": FakeTime}
    exec(compile(ast.Module([node], type_ignores=[]), "bench.py", "exec"), ns)
    return ns["measure_latency"], clock


@pytest.mark.parametrize("reps", [1, 2, 7, 40, 101])
def test_p50_p99_is_bench_rule(reps):
    from shine_tpu_torch.utils.meter import p50_p99

    measure, clock = _bench_measure_latency()
    walls = np.random.default_rng(reps).permutation(reps) * 0.25 + 1.0
    clock["ticks"] = iter(np.column_stack([np.zeros(reps), walls / 1e3]).ravel().tolist())
    want = measure(lambda: None, reps=reps)
    got = p50_p99([(w / 1e3 - 0.0) * 1e3 for w in walls])
    assert tuple(round(x, 2) for x in got) == want


@pytest.fixture(scope="module")
def latency(tmp_path_factory, one_thread):
    """The probe in process on a JAX graph of the set: (records, the set)."""
    tmp = tmp_path_factory.mktemp("latency")
    ds = j_synthetic_dataset(n=LAT["n"], dim=LAT["d"], num_queries=LAT["nq"], seed=7,
                             gt_k=11)
    graph = j_build_graph(ds.base, HNSWParams(M=16, ef_construction=200), threads=1)
    path = str(tmp / "graph.npz")
    j_save_graph(graph, path)
    script = load_scale_script("torch_latency_probe")
    recs = script.run(script.Config(**LAT, graph_path=path), CPU, str(tmp / "lat.jsonl"))
    return recs, ds, graph


def test_latency_probe_records(latency):
    recs, _, _ = latency
    probes = [r for r in recs if r["stage"] == "probe"]
    assert [(r["engine"], r["batch"]) for r in probes] == [
        (e, b) for b in (1, 8, 64, 512) for e in ("hnsw", "fastflat")]
    for r in probes:
        assert {"engine", "batch", "ms", "qps", "recall10"} <= set(r)
        assert r["ms"] > 0 and r["qps"] > 0 and r["device"] == "cpu" and r["card"] is None
        assert ("p50_ms" in r) == (r["batch"] in (1, 64))
        if "p50_ms" in r:
            assert r["p99_ms"] >= r["p50_ms"] > 0
    assert [r["tq"] for r in probes if r["engine"] == "fastflat"] == [128, 128, 128, 512]


def _jax_fastflat_keep1(base, queries, kb: int, cls: int) -> np.ndarray:
    """The JAX FastFlatIndex's keep1 unfused scan route (its TPU route:
    ``classmax_scan`` in interpret mode, ``top_k``, ``rerank_topk``; on the
    CPU its own index takes the block-max route), ids in the caller's space."""
    jidx = JFastFlatIndex(base, interpret=True)
    q = jnp.asarray(queries, jnp.float32)
    q_ext = j_pack_ext_query(q, jidx.ext.shape[1]).astype(jnp.bfloat16)
    m1, a1 = j3.classmax_scan(jidx.ext, q_ext, tq=q.shape[0], tn=max(2048, cls), cls=cls,
                              interpret=True)
    _, sel = jax.lax.top_k(m1, kb)
    cand = jnp.take_along_axis(a1, sel, axis=1)
    cand = jnp.where(cand < jidx.n, cand, -1)
    _, ids = jd.rerank_topk(jidx.vectors, jidx.sqnorms, q, cand, 10, jidx.metric)
    ids = np.asarray(ids)
    return np.where(ids >= 0, jidx.perm[np.maximum(ids, 0)], -1)


def test_latency_probe_recall_matches_jax(latency):
    from shine_tpu_torch.models.flat import FastFlatIndex

    recs, ds, graph = latency
    q, gt = ds.queries, ds.ground_truth
    h_ids, _ = JHNSWIndex(graph).search(q, SearchParams(k=10, ef=64, frontier=8),
                                        batch_size=len(q))
    kb, cls, keep2, fused = FastFlatIndex(ds.base, device=CPU)._resolve_knobs(
        0, 0, None, None, False)
    assert not keep2 and not fused  # the route _jax_fastflat_keep1 takes
    f_ids = _jax_fastflat_keep1(ds.base, q, kb, cls)
    for r in (r for r in recs if r["stage"] == "probe"):
        B = r["batch"]
        ids = h_ids if r["engine"] == "hnsw" else f_ids
        want = j_recall_at_k(ids[:B], gt[:B], 10)
        assert abs(r["recall10"] - want) <= RECALL_TOL, (r["engine"], B, r["recall10"], want)


# --- (d) the ICI study --------------------------------------------------------

ICI = dict(n=2048, d=16, pool=256, nq=256, alphas=(1.25,))
ICI_POINTS = [("compact", False, None, 0.15), ("compact", True, "static", 0.15)]


@pytest.fixture(scope="module")
def ici_graph(tmp_path_factory):
    ds = j_synthetic_dataset(n=ICI["n"], dim=ICI["d"], num_queries=ICI["pool"], seed=7,
                             gt_k=10)
    graph = j_build_graph(ds.base, HNSWParams(M=16, ef_construction=100), threads=1)
    path = str(tmp_path_factory.mktemp("ici") / "graph.npz")
    j_save_graph(graph, path)
    return ds, graph, path


@pytest.mark.parametrize("point", range(len(ICI_POINTS)))
def test_ici_counters_match_jax(point, ici_graph, tmp_path, one_thread):
    ds, graph, path = ici_graph
    exchange, adaptive, routing, ratio = ICI_POINTS[point]
    script = load_scale_script("torch_exp_ici_exchange")
    cfg = script.Config(**ICI, graph_path=path, exchanges=((exchange, adaptive),),
                        routes=((routing, ratio),))
    (row,) = script.run(cfg, CPU, str(tmp_path / "ici.jsonl"))
    with open(tmp_path / "ici.csv") as f:
        assert list(csv.DictReader(f))[0]["exchange"] == row["exchange"]
    _, q, pool_idx = j_skewed_workload(ds.queries, total=ICI["nq"], alpha=1.25, warmup=0,
                                       seed=3)
    j = JShardedIndex(graph, j_shard_mesh(8), cache_capacity=int(ratio * ICI["n"]),
                      routing=routing or False)
    ids, _ = j.search(q, SearchParams(k=10, ef=64, exchange=exchange,
                                      adaptive_slack=adaptive), batch_size=256)
    assert row["recall"] == j_recall_at_k(ids, ds.ground_truth[pool_idx], 10)
    assert row["rpc_rounds"] == j.rpc_rounds and row["ici_lanes"] == j.ici_lanes
    assert (row["cache_hits"], row["cache_misses"]) == (j.cache_hits, j.cache_misses)
    assert row["cache_hit_rate"] > 0 and row["rpc_rounds"] > 0
    np.testing.assert_allclose(row["ici_bytes"], j.ici_bytes, rtol=BYTES_RTOL)


# --- (e) the routed sharded studies -------------------------------------------

ROUTED = dict(n=8192, p_locs=(1,))
SKEW_CELL = dict(alphas=(1.25,), p_locs=(1,), kbs=(16,))  # one alpha and P_loc


@pytest.fixture(scope="module")
def jax_routed():
    """The JAX recipe's index at ``ROUTED["n"]`` rows on 8 virtual devices,
    its 256 queries and their exact top-10 (both studies' set)."""
    n, d, nq = ROUTED["n"], lane_study.D, 256
    key = jax.random.PRNGKey(21)
    centers = jax.random.normal(jax.random.PRNGKey(22), (32, d)) * 4.0
    rng = np.random.default_rng(23)
    anchors = np.asarray(j_regen_rows(key, centers, jnp.asarray(
        rng.integers(0, n, nq), dtype=jnp.int32)))
    queries = anchors + rng.normal(size=(nq, d)).astype(np.float32) * 0.3
    idx, gt = j_routed_build(n, d, j_shard_mesh(8), row_source=(key, centers),
                             cap_target=1024, cls=256, train_size=65_536, seed=24,
                             queries=queries)
    return idx, queries, gt


def _jax_serve(idx, queries, P_loc: int):
    return idx.search(queries, 10, probes=16, shared=32, tile=32, shared_local=P_loc,
                      kk=64, batch_size=256, fallback=0)


def test_routed_sharded_counters_match_jax(tmp_path, one_thread, jax_routed):
    script = load_scale_script("torch_exp_routed_sharded")
    cfg = script.Config(**ROUTED)
    recs = script.run(cfg, CPU, str(tmp_path / "routed.jsonl"))
    build, (got,) = recs[0], recs[1:]
    idx, queries, gt = jax_routed
    ids, _ = _jax_serve(idx, queries, 1)
    assert build["C"] == got["C"] == idx.C
    assert (got["lanes_used"], got["overflow"]) == (idx.last_lanes, idx.last_overflow)
    assert got["overflow"] > 0 and got["lane_window"] == (cfg.nq // 32) * 8 * 1
    assert got["coverage"] == pytest.approx(idx.last_coverage, abs=1e-6)
    assert abs(got["recall10"] - j_recall_at_k(ids, gt, 10)) <= ROUTED_RECALL_GAP


def test_skew_capacity_mesh_cell_matches_jax(tmp_path, one_thread, jax_routed):
    """One alpha and P_loc of the skew x budget study: the stream drawn as
    the JAX script draws it, owned lanes, overflow and coverage equal to
    the JAX index's on that stream."""
    script = load_scale_script("torch_exp_skew_capacity_mesh")
    cfg = script.Config(n=ROUTED["n"], **SKEW_CELL)
    recs = script.run(cfg, CPU, str(tmp_path / "scm.jsonl"))
    (got,) = [r for r in recs if r["stage"] == "routed"]
    (ff,) = [r for r in recs if r["stage"] == "fastflat_sharded"]
    idx, queries, gt = jax_routed
    perm = np.random.default_rng(31).permutation(len(queries))
    sel = perm[j_zipf_ranks(len(queries), 1.25, cfg.stream, seed=7)]
    np.testing.assert_array_equal(script.stream_ids(cfg, 1.25), sel)
    ids, _ = _jax_serve(idx, queries[sel], 1)
    assert (got["lanes_used"], got["overflow"]) == (idx.last_lanes, idx.last_overflow)
    assert got["overflow"] > 0 and got["lane_window"] == (cfg.stream // 32) * 8 * 1
    assert got["coverage"] == pytest.approx(idx.last_coverage, abs=1e-6)
    assert abs(got["recall10"] - j_recall_at_k(ids, gt[sel], 10)) <= ROUTED_RECALL_GAP
    assert ff["recall10"] == 1.0 and ff["scanned_rows"] > 0


# --- (f) the sustained sweep --------------------------------------------------

def _jax_stream_size(nq: int, reps: int, b: int) -> int:
    """The JAX script's ``nq_s = ...`` expression, evaluated as written."""
    tree = ast.parse(open(os.path.join(SCRIPTS, "sustained_b_sweep.py")).read())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "nq_s")
    return eval(compile(ast.Expression(node.value), "sustained_b_sweep.py", "eval"),
                {"max": max, "NQ": nq, "REPS": reps, "b": b})


@pytest.mark.parametrize("nq,reps,b", [(10_000, 5, 2048), (10_000, 5, 16384),
                                       (10_000, 1, 16384), (512, 2, 256), (1000, 3, 7)])
def test_stream_size_is_jax_formula(nq, reps, b):
    script = load_scale_script("torch_sustained_b_sweep")
    assert script.stream_size(nq, reps, b) == _jax_stream_size(nq, reps, b)


def test_sustained_run(tmp_path, one_thread):
    script = load_scale_script("torch_sustained_b_sweep")
    cfg = script.Config(n=2048, d=32, nq=256, reps=2, batches=(512,))
    (rec,) = script.run(cfg, CPU, str(tmp_path / "sb.jsonl"))
    assert (rec["batch"], rec["nq_s"], rec["dispatches"]) == (512, 512, 1)
    assert rec["qps"] > 0 and rec["recall10"] > 0.99 and rec["card"] is None
