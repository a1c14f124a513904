"""Rules the PyTorch port keeps.

- No module of `sparknet_tpu_torch/`, and not `chip_smoke.py`, imports jax,
  jaxlib or the JAX package (AST scan), and importing every module of the
  port leaves jax out of `sys.modules` (subprocess).
- Entry points run on the card by default and raise without one unless
  the caller passes device="cpu".
- The LRN wrapper counts kernel launches only: CPU tensors take the plain
  version, never load the kernel library and leave the count at 0.
- `chip_smoke.py` exits non-zero and prints no result without a card, and
  when the package is not beside it.
- Kernel binaries are keyed by their source.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.device import resolve_device
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.ops import _build, cuda_lrn

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sparknet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sparknet_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_the_jax_package(path):
    for mod in _imported_roots(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {mod}"


def test_importing_every_port_module_leaves_jax_unloaded():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m.removesuffix('.__init__')}\n"
                      for m in mods)
            + "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sparknet_tpu'))\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("clean")


def test_entry_points_default_to_the_card():
    spec = zoo.lenet(batch=1)
    if torch.cuda.is_available():
        assert TorchNet(spec).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchNet(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert TorchNet(spec, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_lrn_launch_counter_stays_zero_on_cpu():
    before = cuda_lrn.lrn_fwd.launches
    x = torch.randn(3, 5, 5, 16)
    y = cuda_lrn.lrn_fwd(x)
    assert y.shape == x.shape
    net = TorchNet(zoo.caffenet(batch=1, crop=67, n_classes=4), device="cpu")
    out = net.forward({"data": np.ones((1, 67, 67, 3), np.float32),
                       "label": np.zeros((1, 1), np.int32)}, ["norm1"])
    assert np.isfinite(out["norm1"]).all()
    assert cuda_lrn.lrn_fwd.launches == before
    if not torch.cuda.is_available():
        assert cuda_lrn.lrn_fwd.launches == 0
        assert not cuda_lrn._libs  # the CPU path never builds or loads


def test_chip_smoke_refuses_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke would run for real")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "is_available() is False" in r.stderr


def test_kernel_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k")
    assert first.parent == tmp_path / "_build"
    assert first == _build.library_path("k")
    src.write_text("// two\n")
    assert _build.library_path("k") != first
    # a built library is loaded as it is: nothing to compile
    first.parent.mkdir()
    _build.library_path("k").write_bytes(b"")
    assert _build.build_all(["k"]) == {"k": _build.library_path("k")}
