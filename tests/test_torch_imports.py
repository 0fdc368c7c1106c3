"""The PyTorch port stands alone: importing every module of
``kubeflow_tpu_torch``, and everything ``chip_smoke.py`` imports, in a
fresh interpreter loads no ``jax*`` module and nothing of the JAX package
``kubeflow_tpu``."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import kubeflow_tpu_torch

ROOT = Path(__file__).resolve().parent.parent

CHECK = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "kubeflow_tpu"))
print(json.dumps(bad))
"""


def port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        kubeflow_tpu_torch.__path__, "kubeflow_tpu_torch."))


def smoke_imports() -> list[str]:
    """Every module ``chip_smoke.py`` imports, at top level or inside its
    functions."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return sorted(names)


def loaded_forbidden(modules: list[str]) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", CHECK.format(modules=modules)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return __import__("json").loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("which", ["port", "chip_smoke"])
def test_imports_load_no_jax_and_no_reference_package(which):
    modules = (port_modules() if which == "port"
               else ["chip_smoke"] + smoke_imports())
    assert set(port_modules()) >= {
        "kubeflow_tpu_torch.serving.engine",
        "kubeflow_tpu_torch.serving.page_pool",
        "kubeflow_tpu_torch.serving.prefix_cache",
        "kubeflow_tpu_torch.serving.speculative",
        "kubeflow_tpu_torch.serving.draft_model",
        "kubeflow_tpu_torch.serving.quant",
        "kubeflow_tpu_torch.serving.disagg",
        "kubeflow_tpu_torch.serving.kv_directory",
        "kubeflow_tpu_torch.serving.model_pool",
        "kubeflow_tpu_torch.serving.sharded",
        "kubeflow_tpu_torch.serving.multihost",
        "kubeflow_tpu_torch.qos",
        "kubeflow_tpu_torch.qos.wfq",
        "kubeflow_tpu_torch.qos.tenants",
        "kubeflow_tpu_torch.qos.accounting",
        "kubeflow_tpu_torch.trace",
        "kubeflow_tpu_torch.trace.span",
        "kubeflow_tpu_torch.trace.tracer",
        "kubeflow_tpu_torch.models.moe",
        "kubeflow_tpu_torch.models.quant_tensor",
        "kubeflow_tpu_torch.models.bert",
        "kubeflow_tpu_torch.parallel.train_step",
        "kubeflow_tpu_torch.parallel.distributed",
        "kubeflow_tpu_torch.parallel.mesh",
        "kubeflow_tpu_torch.parallel.sharding",
        "kubeflow_tpu_torch.parallel.pipeline",
        "kubeflow_tpu_torch.ops.ring_attention",
        "kubeflow_tpu_torch.elastic",
        "kubeflow_tpu_torch.elastic.protocol",
        "kubeflow_tpu_torch.elastic.checkpoint",
        "kubeflow_tpu_torch.elastic.runtime",
        "kubeflow_tpu_torch.training.__main__",
        "kubeflow_tpu_torch.training.checkpoint",
        "kubeflow_tpu_torch.training.data",
        "kubeflow_tpu_torch.training.optim",
        "kubeflow_tpu_torch.training.trainer",
        "kubeflow_tpu_torch.utils.profiler",
    }
    assert loaded_forbidden(modules) == []


def test_port_sources_name_no_reference_import():
    files = list((ROOT / "kubeflow_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "flax", "optax", "orbax",
                                   "kubeflow_tpu"), f"{path}: {mod}"
