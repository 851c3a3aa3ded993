"""``scripts/torch_scale_capacity.py`` end to end on the CPU at 65,536
row-keyed rows: the routed build (no base held, stage seconds recorded)
served at one sweep point and with its spill, and the int8 split tables at
the auto knobs; every record appended as one JSON line."""

import importlib.util
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "torch_scale_capacity", os.path.join(ROOT, "scripts", "torch_scale_capacity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ENV = {
    "routed": {"SHINE_CR_N": "65536", "SHINE_CR_SWEEP": "8:12:32",
               "SHINE_GT_CROSSCHECK": "0"},
    "split": {"SHINE_CAPS_N": "65536", "SHINE_CAPS_KB": "32",
              "SHINE_GT_NSUB": "16384"},
}


@pytest.mark.parametrize("family", ["routed", "split"])
def test_main_at_65536_rows_on_the_cpu(script, family, tmp_path, monkeypatch):
    for k, v in ENV[family].items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "caps.jsonl"
    recs = script.main([family, "--device", "cpu", "--nq", "64", "--out", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == json.loads(json.dumps(recs))
    assert all(r["n"] == 65536 and r["device"] == "cpu" and r["card"] is None
               for r in lines)
    ingest = lines[0]
    assert ingest["stage"] == "ingest" and ingest["table_gb"] > 0
    searches = [r for r in lines if r["stage"].startswith("search")]
    assert all(r["recall10"] > 0.95 and r["recall10_eps"] >= r["recall10"]
               and r["qps"] > 0 for r in searches)
    if family == "routed":
        assert set(ingest["timings"]) == {"train", "choices", "assign", "gt_fold", "pack"}
        assert ingest["C"] == 17 and not ingest["base_resident"]
        assert [r["stage"] for r in searches] == ["search", "search_fallback"]
        assert 0 < searches[0]["coverage"] <= 1
    else:
        assert [r["stage"] for r in lines] == ["ingest", "gt-crosscheck", "search"]
        assert lines[1]["gt_overlap"] > script.MIN_CROSSCHECK
        assert searches[0]["knobs"][0] == 32
