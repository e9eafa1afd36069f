"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package nor ``ml_dtypes`` (which comes with JAX and is missing where the
port runs on the card), builds nothing when imported, and its entry points
never fall back to the CPU without being asked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


# what no module of the port may import
FOREIGN = ("jax", "jaxlib", "repro", "ml_dtypes")


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FOREIGN!r})\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels.gas_scatter import kernel\n"
        "assert kernel._lib is None\n"
        "from repro_torch.kernels.flash_attention import kernel as fk\n"
        "assert fk._lib is None\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import_in_source(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FOREIGN]
    assert not bad, bad


def test_entry_points_refuse_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    from repro_torch.common.schema import init_params
    from repro_torch.core.gcn import (GCNConfig, feature_table, gcn_schema,
                                      params_from_jax)
    from repro_torch.configs import smoke_config
    from repro_torch.common.config import TrainConfig
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.serving import ServingEngine
    from repro_torch.train import init_state

    feats = np.zeros((4, 3), np.float32)
    indptr, indices = np.zeros(5, np.int64), np.zeros(0, np.int64)
    calls = [
        lambda: ServingEngine(feats, indptr, indices),
        lambda: init_params(gcn_schema(GCNConfig(n_features=3))),
        lambda: params_from_jax({"w": feats}),
        lambda: feature_table(feats),
        lambda: serve.main(["--requests", "1"]),
        lambda: init_params(transformer.model_schema(
            smoke_config("whisper-base"))),
        lambda: transformer.params_from_jax({"embed": {"table": feats}}),
        lambda: serve.main(["--workload", "lm", "--arch", "whisper-base",
                            "--reduced"]),
        lambda: serve.main(["--workload", "lm", "--arch", "mamba2-780m",
                            "--reduced"]),
        lambda: train.main(["--workload", "lm", "--arch", "qwen1.5-0.5b",
                            "--reduced"]),
        lambda: init_state(smoke_config("recurrentgemma-2b"), TrainConfig()),
        lambda: init_params(transformer.model_schema(
            smoke_config("deepseek-moe-16b")), draw="device"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert ServingEngine(feats, indptr, indices, device="cpu").device.type \
        == "cpu"


#: the sharded LM's modules: the rule table, the named
#: mesh, the collectives along its axes, the mesh-aware model, step,
#: optimiser, checkpoint and pipeline
SHARDED_LM_MODULES = (
    "repro_torch.common.logical", "repro_torch.launch.mesh",
    "repro_torch.core.collectives", "repro_torch.common.schema",
    "repro_torch.models.embedding", "repro_torch.models.layers",
    "repro_torch.models.moe", "repro_torch.models.transformer",
    "repro_torch.train.step", "repro_torch.train.pipeline",
    "repro_torch.optim.adamw", "repro_torch.checkpoint.manager",
    "repro_torch.analysis.contracts")


def test_sharded_lm_modules_import_neither_jax_nor_repro():
    """Each of the sharded LM's modules is among those the checks above
    walk, and imports alone, in a fresh interpreter, no module of JAX,
    ``repro`` or ``ml_dtypes``."""
    assert set(SHARDED_LM_MODULES) <= set(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {list(SHARDED_LM_MODULES)!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FOREIGN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
