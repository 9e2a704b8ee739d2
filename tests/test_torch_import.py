"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

Every module of ``repro_torch`` is imported in a fresh interpreter where
``import jax`` fails, and afterwards no ``repro`` module may be loaded.
"""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "reference_loaded": loaded,
                  "triton_loaded": "triton" in sys.modules}))
"""


def _probe() -> dict:
    import json
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def probe():
    return _probe()


def test_every_module_imports_without_jax(probe):
    expected = {"repro_torch.core.plan", "repro_torch.core.engine",
                "repro_torch.kernels.spmm", "repro_torch.kernels.edge_softmax",
                "repro_torch.kernels.quantize", "repro_torch.comm.compress",
                "repro_torch.graph.halo", "repro_torch.models.gnn.model",
                "repro_torch.convert", "repro_torch.configs.gnn_datasets",
                "repro_torch.configs.rwkv6_1_6b",
                "repro_torch.configs.zamba2_7b",
                "repro_torch.kernels.linear_scan",
                "repro_torch.models.transformer.config",
                "repro_torch.models.transformer.norms",
                "repro_torch.models.transformer.initutils",
                "repro_torch.models.transformer.scan_common",
                "repro_torch.models.transformer.rwkv6",
                "repro_torch.models.transformer.rope",
                "repro_torch.models.transformer.mlp",
                "repro_torch.models.transformer.attention",
                "repro_torch.models.transformer.mamba2",
                "repro_torch.models.transformer.moe",
                "repro_torch.models.transformer.blocks",
                "repro_torch.models.transformer.model",
                "repro_torch.models.transformer.parallel",
                "repro_torch.serving.core", "repro_torch.serving.engine",
                "repro_torch.serving.gnn", "repro_torch.checkpoint.store",
                "repro_torch.checkpoint.manager",
                "repro_torch.checkpoint.chaos", "repro_torch.launch.train",
                "repro_torch.launch.mesh", "repro_torch.data.tokens",
                "repro_torch.utils.logging", "repro_torch.distributed.steps",
                "repro_torch.configs.shapes", "repro_torch.distributed.hints",
                "repro_torch.distributed.sharding",
                "repro_torch.distributed.tensor_parallel",
                "repro_torch.launch.dryrun"}
    assert expected <= set(probe["modules"])


def test_no_reference_module_is_loaded(probe):
    assert probe["reference_loaded"] == []


def test_kernels_do_not_import_triton_at_import_time(probe):
    # the port's kernels are CUDA C++ built with nvcc: no module needs
    # triton, so hosts without it (and the CPU tests) import every module
    assert probe["triton_loaded"] is False


def test_port_sources_import_no_triton():
    """Not at import time, nor inside a launcher: every kernel of the port
    is a CUDA source under ``kernels/csrc``."""
    import re
    pattern = re.compile(r"^\s*(import|from)\s+triton\b", re.M)
    found = [str(p) for p in (SRC / "repro_torch").rglob("*.py")
             if pattern.search(p.read_text())]
    assert found == []
