"""``scripts/torch_scale_validation.py`` on the CPU at 20,000 x 32 (20,480
rows once rounded up), 256 queries, the IVF builds cut through the script's
own knobs: one run as a subprocess (every stage recorded, every returned id
a real row), then the script's stages against the JAX package on the same
seed: the data stage against ``device_synthetic_dataset``, the FastFlat
shuffle against ``FastFlatIndex.from_device``'s, the IVF layouts' C and cap
and the fine layout's recall against ``IVFIndex.from_device``'s."""

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
from shine_tpu.io import recall_at_k as j_recall_at_k
from shine_tpu.models import flat as jf
from shine_tpu.models import ivf as jivf
from shine_tpu_torch.io import recall_at_k
from shine_tpu_torch.models.flat import FastFlatIndex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_scale_validation.py")
N, D, NQ = 20_000, 32, 256
N_ROWS = 20_480  # n rounded up to a multiple of 4096, in both packages
# the IVF builds cut to this size: a fine layout of C = 160 (target_cap 128),
# a coarse one of 64 clusters, every row in the training sample
FINE = dict(target_cap=128, train_size=N_ROWS, iters=20)
COARSE = dict(num_clusters=64, train_size=N_ROWS, iters=20)
ENV = {"SHINE_10M_N": str(N), "SHINE_10M_D": str(D),
       "SHINE_10M_FINE_CAP": str(FINE["target_cap"]),
       "SHINE_10M_FINE_TRAIN": str(N_ROWS),
       "SHINE_10M_COARSE_C": str(COARSE["num_clusters"]),
       "SHINE_10M_COARSE_TRAIN": str(N_ROWS)}
RECALL_GAP = 0.02  # the IVF k-means sums in other orders than XLA's (C5)


@pytest.fixture(scope="module")
def script():
    return load_scale_script("torch_scale_validation")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The script run once, as a user runs it, both phases."""
    out = tmp_path_factory.mktemp("validation") / "validation.jsonl"
    env = {**os.environ, **ENV, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, SCRIPT, "--device", "cpu", "--nq", str(NQ), "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return [json.loads(x) for x in out.read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_data():
    return jds.device_synthetic_dataset(n=N, dim=D, num_queries=NQ, seed=17, gt_k=11)


def test_records_of_one_run(records, script):
    stages = [r["stage"] for r in records]
    assert stages == (["gen+gt", "margin", "gt-crosscheck", "data_done", "fastflat_build"]
                      + ["fastflat"] * len(script.POINTS)
                      + ["fastflat_build", "fastflat", "fastflat_done", "ivf_build"]
                      + ["ivf"] * len(script.FINE_PROBES) + ["ivf_coarse_build"]
                      + ["ivf_routed"] * len(script.ROUTES) + ["ivf_done"])
    assert all(r["n"] == N and r["d"] == D and r["device"] == "cpu" and r["card"] is None
               for r in records)
    by = {r["stage"]: r for r in records}
    assert by["gen+gt"]["n_rows"] == N_ROWS and by["gt-crosscheck"]["gt_overlap"] == 1.0
    # under the limit, the default index is shuffled, as the JAX package's
    default = next(r for r in records if r["stage"] == "fastflat_build")
    assert default["shuffled"] and default["rows_bytes"] == N_ROWS * D * 4
    assert default["n_pad"] == N_ROWS
    served = [r for r in records if r["stage"] in ("fastflat", "ivf", "ivf_routed")]
    assert all(r["ids_in_range"] and r["qps"] > 0 for r in served)
    flat = [r for r in served if r["stage"] == "fastflat"]
    assert [(r["kb"], r["cls"], r["tq"], r["keep2"]) for r in flat[:-1]] == list(script.POINTS)
    assert flat[-1]["index"] == "shuffled" and flat[-1]["kb"] == script.POINTS[0][0]
    for r in flat:
        assert 0.95 < r["recall10"] <= r["recall10_eps"] and r["recall10_margin"] > 0.95
    fine = [r for r in served if r["stage"] == "ivf"]
    assert [r["probes"] for r in fine] == list(script.FINE_PROBES)
    assert fine[0]["recall10"] <= fine[1]["recall10"] <= fine[2]["recall10"]
    assert by["ivf_build"]["clusters"] == 160 and by["ivf_coarse_build"]["clusters"] == 64
    for r in (r for r in served if r["stage"] == "ivf_routed"):
        assert r["recall10"] > 0.95 and 0 < r["coverage"] <= 1 and r["step_gb"] > 0


def test_data_stage_matches_jax(script, jax_data):
    cfg = script.Config(n=N, d=D, nq=NQ)
    dev = torch.device("cpu")
    ds, mm = script.make_data(cfg, dev, script.Peaks(dev), lambda rec: rec)
    assert ds.n == jax_data.n == N_ROWS
    # the rows agree to a few ulps, so near ties may swap places: the same
    # top-10 set where the boundary is real, and the top-10s all but equal
    got, gt = ds.ground_truth, np.asarray(jax_data.ground_truth)
    np.testing.assert_array_equal(np.sort(got[mm, :10], 1), np.sort(gt[mm, :10], 1))
    assert recall_at_k(got, gt, 10) >= 0.999


def test_fastflat_shuffle_matches_jax(jax_data):
    """The default index's permutation at this n is the JAX package's."""
    base = np.array(jax_data.base_dev)
    got = FastFlatIndex.from_device(torch.from_numpy(base))
    want = jf.FastFlatIndex.from_device(jnp.asarray(base))
    assert got.perm is not None
    np.testing.assert_array_equal(got.perm, want.perm)


def test_ivf_layouts_match_jax(records, jax_data):
    """Both layouts' C and cap are the JAX package's at the same arguments,
    and the fine layout's recall at probes 16 is within RECALL_GAP of its."""
    base = jnp.asarray(jax_data.base_dev)
    by = {r["stage"]: r for r in records}
    fine = jivf.IVFIndex.from_device(base, seed=7, **FINE)
    coarse = jivf.IVFIndex.from_device(base, seed=7, **COARSE)
    assert (by["ivf_build"]["clusters"], by["ivf_build"]["cap"]) == (
        fine.data.num_clusters, fine.data.cap)
    assert (by["ivf_coarse_build"]["clusters"], by["ivf_coarse_build"]["cap"]) == (
        coarse.data.num_clusters, coarse.data.cap)
    ids, _ = fine.search(jax_data.queries, 10, probes=16, batch_size=512)
    want = j_recall_at_k(ids, np.asarray(jax_data.ground_truth), 10)
    got = next(r for r in records if r["stage"] == "ivf" and r["probes"] == 16)
    assert abs(got["recall10"] - want) <= RECALL_GAP, (got["recall10"], want)
