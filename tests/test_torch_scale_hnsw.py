"""``scripts/torch_scale_hnsw.py`` on the CPU at 8,192 x 32, M=8: one run as
a subprocess (every stage recorded, f32 and int8 rows served), a rerun that
resumes from its stage file and builds the same graph, and the script's
data stage against the JAX package's ``device_synthetic_dataset`` and
``margin_mask`` on the same seed."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import load_scale_script
from shine_tpu.io import device_synth as jds
from shine_tpu.io import recall as jrec
from shine_tpu_torch.io import load_graph, recall_at_k
from shine_tpu_torch.utils.meter import PEAK_BF16, PEAK_BYTES, scan_bound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_scale_hnsw.py")
N, D, M, NQ = 8192, 32, 8, 256
ENV = {"SHINE_10MH_N": str(N), "SHINE_10MH_D": str(D), "SHINE_10MH_M": str(M),
       "SHINE_10MH_ROWS": "f32,int8", "SHINE_10MH_EFS": "64"}


@pytest.fixture(scope="module")
def script():
    return load_scale_script()


@pytest.fixture
def one_thread():
    """torch's CPU products on one thread, as in the subprocess below: the
    order of their f32 sums then does not follow the core count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """The script run once, as a user runs it: (records, cache directory)."""
    tmp = tmp_path_factory.mktemp("scale_hnsw")
    out, cache = tmp / "hnsw.jsonl", tmp / "cache"
    env = {**os.environ, **ENV, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, SCRIPT, "--device", "cpu", "--nq", str(NQ), "--out", str(out),
         "--cache", str(cache)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return [json.loads(x) for x in out.read_text().splitlines()], cache


def test_records_of_one_run(first_run):
    recs, cache = first_run
    assert [r["stage"] for r in recs] == [
        "gen+gt", "margin", "base-download", "gt-crosscheck", "fastbuild", "checkpoint",
        "upload", "hnsw", "upload", "hnsw"]
    assert all(r["n"] == N and r["M"] == M and r["pool"] == 0 and r["device"] == "cpu"
               and "card" in r and r["card"] is None for r in recs)
    by = {r["stage"]: r for r in recs}
    assert 0 < by["margin"]["margin_frac"] <= 1
    assert by["gt-crosscheck"]["gt_overlap"] == 1.0
    build = by["fastbuild"]
    assert not build["resumed"] and build["level0_built"] and build["seconds"] > 0
    t = build["timings"]
    assert {"levels", "plan", "components", "upper_levels", "total"} <= set(t)
    assert t["levels"][0]["n"] == N and "knn_select" in t["levels"][0]  # the fused sweep
    assert t["plan"]["layout"] == "ext" and t["plan"]["batch"] > 0
    assert os.path.exists(by["checkpoint"]["path"])
    served = [r for r in recs if r["stage"] == "hnsw"]
    assert [r["rows"] for r in served] == ["f32", "int8"]
    for r in served:
        assert r["ef"] == 64 and r["qps"] > 0 and r["beam_steps"] > 0
        assert 0.9 < r["recall10"] <= r["recall10_eps"] and r["recall10_margin"] > 0.9
        assert r["U"] == build["upper_vertices"] > 0


def test_resume_builds_the_same_graph(script, first_run, tmp_path, one_thread):
    _, cache = first_run
    cfg = script.Config(n=N, d=D, M=M, rows=(), efs=(), rebuild=True, resume=True,
                        nq=NQ)
    ckpt, stage = cfg.paths(str(cache))
    want = load_graph(ckpt)
    assert os.path.exists(stage)
    recs, got = script.run(cfg, torch.device("cpu"), str(tmp_path / "o.jsonl"), str(cache))
    build = next(r for r in recs if r["stage"] == "fastbuild")
    assert build["resumed"] and not build["level0_built"]
    for name in ("levels", "neighbors0", "upper_row", "upper_neighbors", "vectors"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.entry_point, got.top_level) == (want.entry_point, want.top_level)


def test_data_stage_matches_jax(script):
    cfg = script.Config(n=N, d=D, M=M, nq=NQ)
    ds, mm = script.make_data(cfg, torch.device("cpu"), lambda rec: rec)
    want = jds.device_synthetic_dataset(n=N, dim=D, num_queries=NQ, seed=script.SEED,
                                        gt_k=11)
    want_mm = jrec.margin_mask(want.queries, jnp.asarray(want.base_dev),
                               np.asarray(want.ground_truth), 10, rtol=1e-4)
    np.testing.assert_array_equal(mm, want_mm)
    # the rows agree to a few ulps, so near ties may swap places: the same
    # top-10 set where the boundary is real, and the top-11 sets all but equal
    got, gt = ds.ground_truth, np.asarray(want.ground_truth)
    np.testing.assert_array_equal(np.sort(got[mm, :10], 1), np.sort(gt[mm, :10], 1))
    assert recall_at_k(got, gt, 11) >= 0.999


def test_scan_bound_counts_the_real_rows():
    """The sweep's scan at 16,777,216 x 128 (width d+2 = 130, 4,096 queries,
    1,024 classes, keep1): the real rows' products over the bf16 peak; the
    ext table's zero columns (to 144) and pad rows add none."""
    n, B, w, cls = 16_777_216, 4096, 130, 1024
    ms, by = scan_bound(n, B, w, w * 2, B * cls * 2)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * B * n * w / PEAK_BF16 * 1e3)
    assert ms == pytest.approx(18.0658, abs=1e-4)
    # one query: the table's bytes set the bound
    ms, by = scan_bound(n, 1, w, w * 2, cls * 2)
    assert by == "bytes"
    assert ms == pytest.approx((n * w * 2 + w * 2 + cls * 8) / PEAK_BYTES * 1e3)
