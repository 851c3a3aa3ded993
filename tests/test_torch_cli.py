"""The port's command line (``python -m shine_tpu_torch``, run with
``--device cpu``) against the JAX package's (``python -m shine_tpu``), both
in this process on the same argv, at the sizes ``tests/test_cli.py`` uses;
and the modules it reads files and workloads with (``io/fbin.py``,
``io/datasets.py``, ``io/skew.py``, ``config.auto_index_family``) against
their JAX counterparts.

The Statistics documents must hold the same keys (the port adds
``meta.device``; ``meta.framework`` names the package). The dense families'
row and distance counts are analytic in the shapes and must be equal. Their
``hbm_gather_bytes`` count the bytes of each package's own table: the JAX
package pads a row to 128 lanes, the port to 16 (FastFlat's packed table:
d + 2 to 128 lanes against ``ext_width``), so only the per-row width may
differ. Recall: flat is exact in both; the other dense families may differ
by up to 0.02, because the JAX CLI's CPU FastFlat runs the block-max route
(K5) and the port runs the class-max route (K2) everywhere, and the two
packages sum distances in other orders (ROADMAP C5). One graph served by
both must give the same recall and expansions within 1% (C5's rule for
hops)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shine_tpu.cli import main as jax_main
from shine_tpu.config import auto_index_family as jax_auto
from shine_tpu.io import datasets as jds
from shine_tpu.io import fbin as jfbin
from shine_tpu.io.skew import skewed_workload as jax_skew
from shine_tpu_torch.cli import main as port_main
from shine_tpu_torch.config import (
    AUTO_FASTFLAT_MAX_ROWS,
    AUTO_ROUTED_MAX_ROWS,
    auto_index_family,
)
from shine_tpu_torch.io import datasets as tds
from shine_tpu_torch.io import fbin as tfbin
from shine_tpu_torch.io.skew import skewed_workload
from shine_tpu_torch.ops.scan import ext_width
from shine_tpu_torch.ops.scan_split import comp_width

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HNSW = ["--synthetic", "2000:16", "--index", "hnsw", "-m", "8",
        "--ef-construction", "50", "--ef-search", "64", "--num-queries", "100"]
PORT_ONLY_META = {"device", "shard_devices"}
DENSE_RECALL_GAP = 0.02
EXPANSION_RTOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def run_jax(argv, capsys) -> dict:
    assert jax_main(argv) == 0
    return _last_json(capsys.readouterr().out)


def run_port(argv, capsys) -> dict:
    assert port_main(argv + ["--device", "cpu"]) == 0
    return _last_json(capsys.readouterr().out)


def _key_sets(doc: dict) -> dict:
    keys = {sec: set(v) for sec, v in doc.items() if isinstance(v, dict)}
    keys["meta"] -= PORT_ONLY_META
    return keys | {"": set(doc)}


def _same_shape(jdoc: dict, tdoc: dict) -> None:
    assert _key_sets(tdoc) == _key_sets(jdoc)
    assert tdoc["meta"]["framework"] == "shine_tpu_torch"
    assert jdoc["meta"]["framework"] == "shine_tpu"
    assert tdoc["meta"]["device"] == "cpu"
    assert tdoc["queries"]["num_queries"] == jdoc["queries"]["num_queries"]


def _jax_row_bytes(index: str, d: int) -> int:
    """Bytes a scanned row takes in the JAX package's tables, whose rows are
    lane-padded to 128 (ops/pallas_scan.py:pack_ext_table, the split
    packers): the packed bf16 row, the int8 split row with its f32 norm and
    scale, the routed row with those and its id."""
    lanes = lambda w: -(-w // 128) * 128  # noqa: E731
    return {"fastflat": 2 * lanes(d + 2), "split": lanes(d) + 8,
            "routed": lanes(d) + 12}[index]


def _port_row_bytes(index: str, d: int) -> int:
    return {"fastflat": 2 * ext_width(d), "split": comp_width(d) + 8,
            "routed": comp_width(d) + 12}[index]


DENSE_CASES = {
    "flat": ["--synthetic", "2000:16", "--index", "flat", "--num-queries", "100"],
    "fastflat": ["--synthetic", "4096:16", "--index", "fastflat",
                 "--num-queries", "100"],
    "split": ["--synthetic", "4096:16", "--index", "split", "--num-queries", "100"],
    "routed": ["--synthetic", "4096:16", "--index", "routed", "--num-queries",
               "100", "--probes", "8", "--ivf-shared", "16", "--ivf-tile", "32",
               "--batch", "128"],
    "auto": ["--synthetic", "4096:16", "--index", "auto", "--num-queries", "100"],
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_family_against_jax_cli(case, capsys):
    argv = DENSE_CASES[case]
    jdoc, tdoc = run_jax(argv, capsys), run_port(argv, capsys)
    _same_shape(jdoc, tdoc)
    jq, tq = jdoc["queries"], tdoc["queries"]
    for key in ("scanned_rows", "distance_computations", "expansions",
                "ici_exchange_bytes"):
        assert tq[key] == jq[key], key
    index = "fastflat" if case == "auto" else case
    if index == "flat":
        assert tq["hbm_gather_bytes"] == jq["hbm_gather_bytes"]
        assert tq["recall"] == jq["recall"] == pytest.approx(1.0)
        return
    # the scanned share of the bytes: everything but the f32 re-rank's
    # rows (kb a query, the excess of distance computations over scanned
    # rows); the routed count has no re-rank term
    d = 16
    rerank = 0 if index == "routed" else \
        (tq["distance_computations"] - tq["scanned_rows"]) * d * 4
    t_scan, j_scan = tq["hbm_gather_bytes"] - rerank, jq["hbm_gather_bytes"] - rerank
    assert t_scan * _jax_row_bytes(index, d) == j_scan * _port_row_bytes(index, d)
    assert abs(tq["recall"] - jq["recall"]) <= DENSE_RECALL_GAP
    assert tq["recall"] > 0.95


def test_jax_stored_graph_served_by_both(tmp_path, capsys):
    ckpt = str(tmp_path / "jax.npz")
    run_jax(HNSW + ["--store-index", ckpt], capsys)
    jdoc = run_jax(HNSW + ["--load-index", ckpt], capsys)
    tdoc = run_port(HNSW + ["--load-index", ckpt], capsys)
    _same_shape(jdoc, tdoc)
    assert "load_index_buffer" in tdoc["timings"]
    assert tdoc["queries"]["recall"] == jdoc["queries"]["recall"]
    assert tdoc["queries"]["recall"] > 0.9
    je, te = jdoc["queries"]["expansions"], tdoc["queries"]["expansions"]
    assert abs(te - je) <= EXPANSION_RTOL * je
    assert tdoc["queries"]["distance_computations"] > 0


def test_port_stored_graph_loads_in_jax_cli(tmp_path, capsys):
    ckpt = str(tmp_path / "port.npz")
    built = run_port(HNSW + ["--store-index", ckpt], capsys)
    assert "store_index_buffer" in built["timings"]
    tdoc = run_port(HNSW + ["--load-index", ckpt], capsys)
    jdoc = run_jax(HNSW + ["--load-index", ckpt], capsys)
    assert tdoc["queries"]["recall"] == built["queries"]["recall"]
    assert jdoc["queries"]["recall"] == tdoc["queries"]["recall"]
    je, te = jdoc["queries"]["expansions"], tdoc["queries"]["expansions"]
    assert abs(te - je) <= EXPANSION_RTOL * je


# the JAX package's floors for these runs (tests/test_cli.py: fast build
# 0.9, int8 rows 0.85; its device build has no CLI test, 0.9 as the others)
BUILD_CASES = {
    "fast_build": (["--fast-build"], 0.9),
    "device_build": (["--device-build"], 0.9),
    "rows_int8": (["--rows", "int8"], 0.85),
}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_port_builds(case, tmp_path, capsys):
    extra, floor = BUILD_CASES[case]
    ckpt = str(tmp_path / "g.npz")
    tdoc = run_port(HNSW + extra + ["--store-index", ckpt], capsys)
    assert tdoc["queries"]["recall"] > floor
    assert tdoc["queries"]["expansions"] > 0
    assert tdoc["build"]["build_time_ms"] > 0
    # a scan build stage-checkpoints layer 0 beside the stored index
    assert os.path.exists(ckpt + ".stage0.npz") == (case == "fast_build")


@pytest.mark.parametrize("alpha", [0.0, 0.75, 1.25])
def test_skewed_workload_matches_jax(alpha):
    pool = np.random.default_rng(5).normal(size=(300, 4)).astype(np.float32)
    got = skewed_workload(pool, total=1000, alpha=alpha, warmup=200, seed=9)
    want = jax_skew(pool, total=1000, alpha=alpha, warmup=200, seed=9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (200, 4) and got[1].shape == (1000, 4)


@pytest.mark.parametrize("overrides", [None, ("10000", "30000")])
def test_auto_index_family_matches_jax(overrides, monkeypatch):
    f, r = int(AUTO_FASTFLAT_MAX_ROWS), int(AUTO_ROUTED_MAX_ROWS)
    if overrides:
        monkeypatch.setenv("SHINE_AUTO_FASTFLAT_MAX", overrides[0])
        monkeypatch.setenv("SHINE_AUTO_ROUTED_MAX", overrides[1])
        f, r = (int(x) for x in overrides)
    edges = [(f, 1), (f + 1, 1), (r, 1), (r + 1, 1), (8 * f, 8),
             (8 * f + 8, 8), (8 * r + 8, 8), (0, 1)]
    got = [auto_index_family(n, shards) for n, shards in edges]
    assert got == [jax_auto(n, shards) for n, shards in edges]
    assert got[:4] == ["fastflat", "routed", "routed", "split"]


@pytest.mark.parametrize("ext,dtype", [(".fbin", np.float32), (".u8bin", np.uint8),
                                       (".i8bin", np.int8)])
def test_bin_files_across_packages(ext, dtype, tmp_path):
    rng = np.random.default_rng(4)
    if dtype == np.float32:
        arr = rng.normal(size=(301, 12)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(info.min, info.max + 1, size=(301, 12)).astype(dtype)
    for write, read, other in ((jfbin.write_bin, tfbin.read_bin, jfbin.read_bin),
                               (tfbin.write_bin, jfbin.read_bin, tfbin.read_bin)):
        path = str(tmp_path / f"x{ext}")
        write(path, arr)
        assert tfbin.read_bin_header(path) == jfbin.read_bin_header(path) == (301, 12)
        np.testing.assert_array_equal(read(path), arr.astype(np.float32))
        np.testing.assert_array_equal(read(path, widen=False), arr)
        for shard in range(3):
            got = read(path, row_filter=(shard, 3))
            np.testing.assert_array_equal(got, arr[shard::3].astype(np.float32))
            np.testing.assert_array_equal(got, other(path, row_filter=(shard, 3)))
        np.testing.assert_array_equal(read(path, max_rows=7), arr[:7].astype(np.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataset_dir_across_packages(writer, tmp_path, capsys):
    ds = tds.synthetic_dataset(n=1500, dim=12, num_queries=80, seed=5)
    root = str(tmp_path / "ds")
    (jds.save_dataset if writer == "jax" else tds.save_dataset)(ds, root)
    for load in (jds.load_dataset, tds.load_dataset):
        back = load(root)
        np.testing.assert_array_equal(back.base, ds.base)
        np.testing.assert_array_equal(back.queries, ds.queries)
        np.testing.assert_array_equal(back.ground_truth, ds.ground_truth)
        assert back.name == "ds"
    argv = ["--data-path", root, "--index", "flat", "--num-queries", "64"]
    tdoc, jdoc = run_port(argv, capsys), run_jax(argv, capsys)
    _same_shape(jdoc, tdoc)
    assert tdoc["queries"]["recall"] == jdoc["queries"]["recall"] == pytest.approx(1.0)
    assert tdoc["meta"]["dataset"] == "ds"


def test_zipf_workload_against_jax_cli(capsys):
    argv = ["--synthetic", "2000:16", "--index", "flat", "--num-queries", "200",
            "--zipf", "1.0", "--warmup", "50"]
    jdoc, tdoc = run_jax(argv, capsys), run_port(argv, capsys)
    _same_shape(jdoc, tdoc)
    assert set(tdoc["timings"]) == set(jdoc["timings"]) == {"warmup", "query"}
    assert tdoc["meta"]["zipf"] == 1.0
    assert tdoc["queries"]["recall"] == jdoc["queries"]["recall"] == pytest.approx(1.0)


IVF_CASES = {
    "ivf": ["--synthetic", "2000:16", "--index", "ivf", "--probes", "8",
            "--ivf-shared", "16", "--ivf-tile", "32"],
    "ivf_routed": ["--synthetic", "2000:16", "--index", "ivf", "--ivf-routed",
                   "--probes", "8", "--ivf-shared", "16", "--ivf-tile", "32"],
}


@pytest.mark.parametrize("case", list(IVF_CASES))
def test_ivf_against_jax_cli(case, capsys):
    """The same layout in both packages from the same seed (the
    farthest-point init's first centre is JAX's draw; the training sample is
    numpy's in both): equal recall and cost counters."""
    argv = IVF_CASES[case]
    jdoc, tdoc = run_jax(argv, capsys), run_port(argv, capsys)
    _same_shape(jdoc, tdoc)
    jq, tq = jdoc["queries"], tdoc["queries"]
    for key in ("recall", "scanned_rows", "distance_computations", "expansions",
                "hbm_gather_bytes", "ici_exchange_bytes"):
        assert tq[key] == jq[key], key
    assert tdoc["build"]["index_size_in_bytes"] == jdoc["build"]["index_size_in_bytes"]


def test_ivf_routed_flag_ignored_elsewhere(capsys):
    """--ivf-routed with another family is ignored, as in the JAX CLI."""
    argv = DENSE_CASES["flat"]
    base, routed = run_port(argv, capsys), run_port(argv + ["--ivf-routed"], capsys)
    assert routed["queries"]["recall"] == base["queries"]["recall"] == pytest.approx(1.0)


# the flags the port once refused, each argv run through both command lines
# (the JAX one on its virtual devices, the port's on a CPU mesh). The hnsw
# builds read a small integer-valued set from files, where every distance
# is exact in both packages and the sharded builds agree bit for bit; the
# fast build's kNN stage shards with SHARD_KNN_MIN lowered in both
INT_HNSW = ["--index", "hnsw", "-m", "8", "--ef-construction", "40",
            "--ef-search", "64", "--batch", "64"]
ONCE_REFUSED = {
    "megabatch": DENSE_CASES["fastflat"] + ["--megabatch"],
    "exchange": ["--synthetic", "4096:16", "--index", "auto", "--num-queries", "100",
                 "--shards", "2", "--exchange", "compact"],
    "device_build": INT_HNSW + ["--shards", "4", "--device-build"],
    "fast_build": INT_HNSW + ["--shards", "4", "--fast-build"],
}
CLI_SHARD_KNN_MIN = 128
ONCE_REFUSED_MIN_RECALL = 0.7


@pytest.fixture(scope="module")
def int_set(tmp_path_factory):
    """225 x 16 integer rows (the device build's rounds of 32, 64 and 128:
    three shapes for JAX to compile), 100 queries, the exact top-10, saved
    as a dataset directory. Entries from -64 to 64 keep every distance exact
    in f32 and make ties between distances rare."""
    from shine_tpu_torch.io import brute_force_knn

    rng = np.random.default_rng(21)
    base = rng.integers(-64, 65, size=(225, 16)).astype(np.float32)
    queries = rng.integers(-64, 65, size=(100, 16)).astype(np.float32)
    gt, _ = brute_force_knn(base, queries, 10)
    root = str(tmp_path_factory.mktemp("ints") / "ints")
    tds.save_dataset(tds.Dataset(base=base, queries=queries, ground_truth=gt,
                                 name="ints"), root)
    return root


@pytest.mark.parametrize("case", list(ONCE_REFUSED))
def test_once_refused_flags_against_jax_cli(case, int_set, capsys, monkeypatch):
    """Each runs in both command lines to the same recall. --megabatch on one
    device changes no answer in either package: each run equals the same
    argv without it, and the two packages differ only as their CPU
    FastFlat routes do (the dense rule above)."""
    import shine_tpu.models.fastbuild as jfb
    from shine_tpu_torch.models import fastbuild as tfb

    monkeypatch.setattr(jfb, "SHARD_KNN_MIN", CLI_SHARD_KNN_MIN)
    monkeypatch.setattr(tfb, "SHARD_KNN_MIN", CLI_SHARD_KNN_MIN)
    argv = ONCE_REFUSED[case]
    if case in ("device_build", "fast_build"):
        argv = ["--data-path", int_set] + argv
    jdoc, tdoc = run_jax(argv, capsys), run_port(argv, capsys)
    _same_shape(jdoc, tdoc)
    jq, tq = jdoc["queries"], tdoc["queries"]
    if case == "megabatch":
        plain = [a for a in argv if a != "--megabatch"]
        assert tq["recall"] == run_port(plain, capsys)["queries"]["recall"]
        assert jq["recall"] == run_jax(plain, capsys)["queries"]["recall"]
        assert abs(tq["recall"] - jq["recall"]) <= DENSE_RECALL_GAP
        return
    assert tdoc["meta"]["shard_devices"] == ["cpu"] * tdoc["meta"]["num_shards"]
    assert tq["recall"] == jq["recall"]
    # the 225-row device build's rounds (up to 128 nodes that cannot see
    # each other) leave it near 0.8 in both packages: a floor for a broken
    # graph only
    assert tq["recall"] > ONCE_REFUSED_MIN_RECALL
    assert tq["ici_exchange_bytes"] > 0
    if case == "exchange":  # auto resolved to the sharded FastFlat
        for key in ("scanned_rows", "distance_computations"):
            assert tq[key] == jq[key], key
    else:
        assert tdoc["build"]["build_time_ms"] > 0


def test_megabatch_with_shards_warns_and_is_ignored(capsys):
    """As in the JAX command line: a warning, then the sharded run's recall,
    the same as without --megabatch and as the JAX command line's."""
    argv = DENSE_CASES["fastflat"] + ["--shards", "4"]
    plain = run_port(argv, capsys)["queries"]["recall"]
    with pytest.warns(UserWarning, match="--megabatch is single-chip only"):
        got = run_port(argv + ["--megabatch"], capsys)["queries"]["recall"]
    with pytest.warns(UserWarning, match="--megabatch is single-chip only"):
        want = run_jax(argv + ["--megabatch"], capsys)["queries"]["recall"]
    assert got == plain == want


# the sharded runs, each on a graph the JAX command line stored: both
# command lines serve it on a mesh of 4 shards (the port's on the CPU)
SHARDED = {
    "cache_routing": ["--cache", "--routing"],
    "compact_slack": ["--exchange", "compact", "--adaptive-slack"],
    "adaptive": ["--cache", "--cache-ratio", "0.2", "--adaptive-cache",
                 "--adaptive-routing", "--zipf", "1.0", "--warmup", "100"],
}


@pytest.fixture(scope="module")
def stored_graph(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded") / "g.npz")
    assert jax_main(HNSW + ["--store-index", path]) == 0
    return path


@pytest.mark.parametrize("case", list(SHARDED))
def test_sharded_hnsw_against_jax_cli(case, stored_graph, capsys):
    capsys.readouterr()
    argv = HNSW + ["--load-index", stored_graph, "--shards", "4", "--batch", "64",
                   *SHARDED[case]]
    jdoc, tdoc = run_jax(argv, capsys), run_port(argv, capsys)
    _same_shape(jdoc, tdoc)
    assert tdoc["meta"]["num_shards"] == 4
    assert tdoc["meta"]["shard_devices"] == ["cpu"] * 4
    jq, tq = jdoc["queries"], tdoc["queries"]
    assert tq["recall"] == jq["recall"]
    assert tq["recall"] > 0.9
    assert abs(tq["expansions"] - jq["expansions"]) <= EXPANSION_RTOL * jq["expansions"]
    assert tq["distance_computations"] == 16 * tq["expansions"]  # M_max0
    assert tq["ici_exchange_bytes"] > 0
    if "--cache" in SHARDED[case]:
        assert tdoc["cache"]["hits"] > 0


def test_sharded_flat_against_jax_cli(capsys):
    argv = DENSE_CASES["flat"] + ["--shards", "4"]
    jdoc, tdoc = run_jax(argv, capsys), run_port(argv, capsys)
    _same_shape(jdoc, tdoc)
    for key in ("scanned_rows", "distance_computations", "hbm_gather_bytes",
                "ici_exchange_bytes"):
        assert tdoc["queries"][key] == jdoc["queries"][key], key
    assert tdoc["queries"]["recall"] == jdoc["queries"]["recall"] == pytest.approx(1.0)


# the sharded scan families: both command lines on one argv over a mesh of 4
# shards (the port's on the CPU); split with --cache, which both ignore off
# hnsw. The builds take the JAX package's draws (the routed build's sample,
# k-means init and the farthest-point init), so that both hold one layout
SHARDED_SCANS = {
    "fastflat": DENSE_CASES["fastflat"],
    "split_cache": DENSE_CASES["split"] + ["--cache"],
    "routed": DENSE_CASES["routed"],
    "ivf": IVF_CASES["ivf"],
    "ivf_routed": IVF_CASES["ivf_routed"],
}


@pytest.mark.parametrize("case", list(SHARDED_SCANS))
def test_sharded_scan_family_against_jax_cli(case, capsys):
    """Both CLIs on the same argv and seed (every seeded draw of the builds
    is JAX's in the port): equal cost counters."""
    argv = SHARDED_SCANS[case] + ["--shards", "4"]
    jdoc, tdoc = run_jax(argv, capsys), run_port(argv, capsys)
    _same_shape(jdoc, tdoc)
    assert tdoc["meta"]["num_shards"] == 4
    assert tdoc["meta"]["shard_devices"] == ["cpu"] * 4
    jq, tq = jdoc["queries"], tdoc["queries"]
    for key in ("scanned_rows", "distance_computations", "expansions",
                "ici_exchange_bytes"):
        assert tq[key] == jq[key], key
    assert tq["ici_exchange_bytes"] > 0
    index = case.split("_")[0]
    if index == "ivf":
        assert tq["hbm_gather_bytes"] == jq["hbm_gather_bytes"]
        assert tdoc["build"]["index_size_in_bytes"] == jdoc["build"]["index_size_in_bytes"]
    else:
        # the scanned share of the bytes at each package's row width; the
        # routed count has no re-rank term
        d = 16
        rerank = 0 if index == "routed" else \
            (tq["distance_computations"] - tq["scanned_rows"]) * d * 4
        t_scan = tq["hbm_gather_bytes"] - rerank
        j_scan = jq["hbm_gather_bytes"] - rerank
        assert t_scan * _jax_row_bytes(index, d) == j_scan * _port_row_bytes(index, d)
    if index == "routed":
        # one plan but k-means sums in other orders: C5's dense rule
        assert abs(tq["recall"] - jq["recall"]) <= DENSE_RECALL_GAP
    else:
        assert tq["recall"] == jq["recall"]
    assert tq["recall"] > 0.95


def test_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_main(["--synthetic", "2000:16", "--index", "flat", "--num-queries", "10"])


def test_python_m_prints_the_statistics_document():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "shine_tpu_torch", "--device", "cpu",
         "--synthetic", "2000:16", "--index", "flat", "--num-queries", "100"],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env,
    )
    assert res.returncode == 0, res.stderr
    doc = _last_json(res.stdout)
    assert doc["queries"]["recall"] == pytest.approx(1.0)
    assert doc["meta"]["device"] == "cpu"


@pytest.mark.parametrize("with_bf16", [True, False])
def test_flat_from_device_and_cost_counters_against_jax(with_bf16):
    """FlatIndex.from_device on a CPU tensor against the JAX package's on a
    device array: the same exact ids, and the same analytic counters."""
    import jax.numpy as jnp

    from shine_tpu.models.flat import FlatIndex as JFlat
    from shine_tpu_torch.models.flat import FlatIndex

    ds = tds.synthetic_dataset(n=3000, dim=16, num_queries=64, seed=8,
                               compute_gt=False)
    port = FlatIndex.from_device(torch.from_numpy(ds.base), with_bf16=with_bf16)
    ref = JFlat.from_device(jnp.asarray(ds.base), with_bf16=with_bf16)
    got, _ = port.search(ds.queries, 10, batch_size=32, use_bf16=with_bf16)
    want, _ = ref.search(ds.queries, 10, batch_size=32, use_bf16=with_bf16)
    np.testing.assert_array_equal(got, want)
    assert (port.data["vectors_bf16"] is port.data["vectors"]) == (not with_bf16)
    for nq, batch in ((64, 32), (1000, 4096)):
        assert (port.cost_counters(nq, 10, batch_size=batch, use_bf16=with_bf16)
                == ref.cost_counters(nq, 10, batch_size=batch, use_bf16=with_bf16))
