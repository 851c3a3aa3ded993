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
_BLOCKER = """
import sys
_BLOCKED = ("jax", "jaxlib", "ml_dtypes", "shine_tpu")
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, _Block())
import importlib
importlib.import_module(sys.argv[1])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in _BLOCKED)
assert not loaded, loaded
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("module", [
    "shine_tpu_torch",
    "shine_tpu_torch.config",
    "shine_tpu_torch.convert",
    "shine_tpu_torch.graph.soa",
    "shine_tpu_torch.io",
    "shine_tpu_torch.io.checkpoint",
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
    "shine_tpu_torch.ops.scan",
    "shine_tpu_torch.ops.scan_routed",
    "shine_tpu_torch.ops.scan_split",
    "shine_tpu_torch.ops.distance",
    "shine_tpu_torch.parallel.placement",
    "chip_smoke",
])
def test_imports_with_jax_blocked(module):
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKER, module], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=_clean_env(),
    )
    assert res.returncode == 0, res.stderr


def _port_sources():
    return [*(REPO / "shine_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]


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
