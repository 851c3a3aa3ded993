"""``scripts/torch_exp_skew.py`` on the CPU against the JAX package's
``scripts/exp_skew_capacity.py`` recipe on the same seed: the routed phase
in process at 16,384 rows, cap_target 1024, cls 256 (the JAX script's CPU
sizes, cut in rows and stream) — the pool's ids bit for bit and its rows
within 4 ulps, every alpha's Zipf stream bit for bit, C and cap equal to
the JAX ``build_routed_split``'s and recall@10 at alpha 0, p 16 within 0.02
of its; and the ``ivf`` phase at 8,192 rows as a user runs it (a
subprocess)."""

import csv
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
from shine_tpu.io import recall_at_k as j_recall_at_k
from shine_tpu.io.device_synth import regen_rows as j_regen_rows
from shine_tpu.io.skew import zipf_ranks as j_zipf_ranks
from shine_tpu.models.routed_split import build_routed_split as j_build_routed_split

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_exp_skew.py")
# the JAX script's CPU sizes (SHINE_SKC_CPU=1), cut to 16,384 rows, one
# cell of its grid and a stream of 128
CFG = dict(n=16_384, pool=1024, stream=128, cap_target=1024, cls=256,
           alphas=(0.0,), probes=(16,), mults=(12,))
ROW_ULPS = 4  # a pool row: a regenerated row + 0.3 * a normal (C5: 3 ulps)
RECALL_GAP = 0.02  # the builds' k-means sum in other orders (C5, C12)
IVF_N, IVF_D, IVF_Q = 8192, 32, 256


@pytest.fixture(scope="module")
def script():
    return load_scale_script("torch_exp_skew")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_pool():
    """The JAX script's pool at these sizes: (k1, centres), ids, rows."""
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(17), 4)
    centers = jax.random.normal(k0, (64, 128), jnp.float32) * 4.0
    qidx = jax.random.randint(k2, (CFG["pool"],), 0, CFG["n"])
    pool = j_regen_rows(k1, centers, qidx) + 0.3 * jax.random.normal(
        k3, (CFG["pool"], 128), jnp.float32)
    return (k1, centers), np.asarray(qidx), np.asarray(pool)


@pytest.fixture(scope="module")
def routed(script, tmp_path_factory, one_thread):
    """The routed phase in process: (records, the CSV's rows)."""
    out = tmp_path_factory.mktemp("skew") / "skew.jsonl"
    cfg = script.Config(**CFG)
    recs = script.run(cfg, torch.device("cpu"), str(out))
    with open(str(out).replace(".jsonl", ".csv")) as f:
        return recs, list(csv.DictReader(f))


def test_pool_matches_jax(script, jax_pool):
    _, want_ids, want = jax_pool
    _, ids, pool = script.make_pool(script.Config(**CFG), torch.device("cpu"))
    np.testing.assert_array_equal(ids, want_ids)
    scale = np.spacing(np.linalg.norm(want, axis=1).astype(np.float32))[:, None]
    assert (np.abs(pool - want) <= ROW_ULPS * scale).all()


@pytest.mark.parametrize("alpha", [0.0, 0.75, 1.25])
def test_stream_matches_jax(script, alpha):
    cfg = script.Config(**{**CFG, "stream": 2048})
    perm = np.random.default_rng(31).permutation(cfg.pool)
    want = perm[j_zipf_ranks(cfg.pool, alpha, cfg.stream, seed=7)]
    np.testing.assert_array_equal(script.stream_ids(cfg, alpha), want)


def test_routed_cell_matches_jax(routed, jax_pool, script):
    recs, rows = routed
    ingest, cell = recs[0], recs[1]
    assert [r["stage"] for r in recs] == ["ingest", "cell"]
    assert not ingest["base_resident"] and ingest["C"] > 0 and ingest["cap"] >= CFG["cap_target"]
    assert cell["P"] == 12 * 16 and cell["P_granted"] == min(192, ingest["C"])
    assert cell["coverage"] == 1.0 and cell["qps"] > 0
    assert cell["stream_digest"] == script.digest(script.stream_ids(
        script.Config(**CFG), 0.0))
    assert [float(rows[0][k]) for k in ("alpha", "p", "P")] == [0.0, 16.0, 192.0]
    row_source, _, pool = jax_pool
    idx, gt = j_build_routed_split(
        CFG["n"], 128, row_source=row_source, cap_target=CFG["cap_target"],
        cls=CFG["cls"], cap_slack=1.05, comp_dtype="int8", seed=17, queries=pool)
    assert (ingest["C"], ingest["cap"]) == (idx.C, idx.cap)
    sel = script.stream_ids(script.Config(**CFG), 0.0)
    ids, _ = idx.search(pool[sel], 10, probes=16, shared=192, tile=32, batch_size=2048,
                        with_dists=False, fallback=0)
    want = j_recall_at_k(ids, gt[sel], 10)
    assert abs(cell["recall10"] - want) <= RECALL_GAP, (cell["recall10"], want)


def test_ivf_phase_recorded(tmp_path):
    out = tmp_path / "skew.jsonl"
    env = {**os.environ, "SHINE_SKEW_N": str(IVF_N), "SHINE_SKEW_D": str(IVF_D),
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, SCRIPT, "ivf", "--device", "cpu", "--nq", str(IVF_Q),
         "--out", str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["stage"] for r in recs] == ["ivf_build"] + ["ivf_alpha"] * 3
    assert recs[0]["clusters"] == IVF_N // 128 and recs[0]["n"] == IVF_N
    assert [r["alpha"] for r in recs[1:]] == [0.0, 0.75, 1.25]
    for r in recs[1:]:
        assert r["recall10"] > 0.95 and 0 < r["coverage"] <= 1 and r["qps"] > 0
        assert (r["probes"], r["shared"], r["tile"]) == (16, 128, 64)
        assert r["fallback_queries"] >= 0 and r["device"] == "cpu" and r["card"] is None
