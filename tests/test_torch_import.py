"""The PyTorch port imports without JAX and without the JAX package, holds
its fp32 precision lock, its entry points refuse to run without a CUDA card
unless asked for the CPU, and its chip script refuses to run without one."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

# a sys.meta_path finder that refuses jax, jaxlib, ml_dtypes and the JAX
# package shine_tpu
_BLOCK = """
import sys
_BLOCKED = ("jax", "jaxlib", "ml_dtypes", "shine_tpu")
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, _Block())
"""
_BLOCKER = _BLOCK + """
import importlib
importlib.import_module(sys.argv[1])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in _BLOCKED)
assert not loaded, loaded
"""
# `python -m shine_tpu_torch --help` under the blocker
_MAIN_HELP = _BLOCK + """
import runpy
sys.argv = ["shine_tpu_torch", "--help"]
try:
    runpy.run_module("shine_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
loaded = sorted(m for m in sys.modules if m.split(".")[0] in _BLOCKED)
assert not loaded, loaded
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("module", [
    "shine_tpu_torch",
    "shine_tpu_torch.cli",
    "shine_tpu_torch.config",
    "shine_tpu_torch.convert",
    "shine_tpu_torch.graph.soa",
    "shine_tpu_torch.io",
    "shine_tpu_torch.io.checkpoint",
    "shine_tpu_torch.io.datasets",
    "shine_tpu_torch.io.device_synth",
    "shine_tpu_torch.io.fbin",
    "shine_tpu_torch.io.recall",
    "shine_tpu_torch.io.skew",
    "shine_tpu_torch.models.build",
    "shine_tpu_torch.models.dynamic",
    "shine_tpu_torch.models.fastbuild",
    "shine_tpu_torch.models.flat",
    "shine_tpu_torch.models.hnsw",
    "shine_tpu_torch.models.ivf",
    "shine_tpu_torch.models.routed_split",
    "shine_tpu_torch.native",
    "shine_tpu_torch.ops.blockmax",
    "shine_tpu_torch.ops.classmax",
    "shine_tpu_torch.ops.gather_score",
    "shine_tpu_torch.ops.regen",
    "shine_tpu_torch.ops.scan",
    "shine_tpu_torch.ops.scan_routed",
    "shine_tpu_torch.ops.scan_split",
    "shine_tpu_torch.ops.distance",
    "shine_tpu_torch.ops.threefry",
    "shine_tpu_torch.parallel",
    "shine_tpu_torch.parallel.fastflat_sharded",
    "shine_tpu_torch.parallel.flat_sharded",
    "shine_tpu_torch.parallel.hot_cache",
    "shine_tpu_torch.parallel.ivf_sharded",
    "shine_tpu_torch.parallel.mesh",
    "shine_tpu_torch.parallel.placement",
    "shine_tpu_torch.parallel.routed_sharded",
    "shine_tpu_torch.parallel.router",
    "shine_tpu_torch.parallel.sharded",
    "shine_tpu_torch.utils",
    "shine_tpu_torch.utils.stats",
    "shine_tpu_torch.utils.timing",
    "chip_smoke",
])
def test_imports_with_jax_blocked(module):
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKER, module], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=_clean_env(),
    )
    assert res.returncode == 0, res.stderr


def test_main_help_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _MAIN_HELP], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=_clean_env(),
    )
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout and "--index" in res.stdout


def _port_scripts():
    return sorted((REPO / "scripts").glob("torch_*.py"))


def _port_sources():
    # the shell script's embedded Python too (torch_skew_budget.sh)
    return [*(REPO / "shine_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
            *_port_scripts(), *(REPO / "scripts").glob("torch_*.sh")]


# each script's module body (its imports; main() is not run) under the blocker
_SCRIPTS = _BLOCK + """
import runpy
for path in sys.argv[1:]:
    runpy.run_path(path, run_name="__blocked__")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in _BLOCKED)
    assert not loaded, (path, loaded)
"""


def test_port_scripts_import_with_jax_blocked():
    scripts = _port_scripts()
    for name in ("torch_scale_hnsw.py", "torch_scale_validation.py", "torch_exp_skew.py",
                 "torch_latency_probe.py", "torch_sustained_b_sweep.py",
                 "torch_exp_sweep.py", "torch_collect_results.py",
                 "torch_exp_ici_exchange.py", "torch_exp_routed_sharded.py",
                 "torch_exp_skew_capacity_mesh.py"):
        assert REPO / "scripts" / name in scripts
    assert REPO / "scripts" / "torch_skew_budget.sh" in _port_sources()
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPTS, *map(str, scripts)], cwd=REPO,
        capture_output=True, text=True, timeout=120, env=_clean_env(),
    )
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes)\b", re.M)
    for path in _port_sources():
        assert not pattern.search(path.read_text()), path


def test_no_jax_package_import_in_port_sources():
    pattern = re.compile(r"^\s*(from|import)\s+shine_tpu\b(?!_torch)", re.M)
    for path in _port_sources():
        assert not pattern.search(path.read_text()), path


@pytest.mark.parametrize("flag", ["allow_tf32", "matmul_precision"])
def test_precision_lock_raises(flag):
    from shine_tpu_torch.ops.distance import check_precision, matmul_nt

    check_precision()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    old_prec = torch.get_float32_matmul_precision()
    try:
        if flag == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="fp32|highest"):
            check_precision()
        with pytest.raises(RuntimeError):
            matmul_nt(torch.ones(2, 3), torch.ones(4, 3))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
        torch.set_float32_matmul_precision(old_prec)
    check_precision()


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the refusal path is not taken")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=_clean_env(),
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=_clean_env(),
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
