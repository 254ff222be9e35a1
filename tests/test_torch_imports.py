"""The port stands alone: no module of ``src/repro_torch/``, not the root
``chip_smoke.py`` and no example of ``examples_torch/`` imports JAX or the
JAX package ``repro``; the examples import nothing of ``benchmarks``
either."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + EXAMPLES
# the port's modules, relative to src/
SRC_NAMES = {str(p.relative_to(ROOT / "src")) for p in SOURCES
             if p.is_relative_to(ROOT / "src")}


def _forbidden(name: str, example: bool = False) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro") + (
        ("benchmarks",) if example else ())


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_found():
    assert len(SOURCES) >= 20
    # the risk-aware joint slice's modules are among them
    assert {"repro_torch/core/risk.py", "repro_torch/core/spatial.py",
            "repro_torch/core/solver.py", "repro_torch/sim/report.py",
            "repro_torch/kernels/vcc_pgd/kernel.py"} <= SRC_NAMES


@pytest.mark.parametrize("name", ("pgd_epoch", "pgd_epoch_ens",
                                  "joint_step"))
def test_every_kernel_source_is_in_the_package(name):
    """Each kernel the dispatcher can launch is built from a source of the
    package, and the build hash covers the header the sources share."""
    from repro_torch.kernels.vcc_pgd import kernel
    src = kernel.SOURCES[name]
    assert src.is_file() and src.parent == kernel.CSRC
    assert '#include "pgd_common.cuh"' in src.read_text()
    assert all(h.is_file() for h in kernel.HEADERS)


def test_serving_slice_modules_are_scanned():
    """The serving slice's subpackages are among the scanned sources."""
    assert {"repro_torch/configs/__init__.py",
            "repro_torch/configs/base.py",
            "repro_torch/configs/zamba2_7b.py",
            "repro_torch/models/transformer.py",
            "repro_torch/models/ssm.py",
            "repro_torch/models/attention.py",
            "repro_torch/launch/serve.py",
            "repro_torch/training.py",
            "repro_torch/kernels/nvcc.py",
            "repro_torch/kernels/flash_attention/kernel.py",
            "repro_torch/kernels/flash_attention/ops.py",
            "repro_torch/kernels/flash_attention/ref.py",
            "repro_torch/kernels/linear_scan/kernel.py",
            "repro_torch/kernels/linear_scan/ops.py",
            "repro_torch/kernels/linear_scan/ref.py"} <= SRC_NAMES


def test_closed_loop_slice_modules_are_scanned():
    """The streaming prediction and MPC recourse modules are among the
    scanned sources."""
    assert {"repro_torch/core/stats.py",
            "repro_torch/core/mpc.py"} <= SRC_NAMES


def test_telemetry_and_fleet_modules_are_scanned():
    """The telemetry layer and the legacy fleet API are among the scanned
    sources."""
    assert {"repro_torch/sim/telemetry.py",
            "repro_torch/core/fleet.py"} <= SRC_NAMES


def test_training_slice_modules_are_scanned():
    """The trainer's modules (data, optimizer, compression, checkpoints,
    the train step and the launcher) are among the scanned sources."""
    assert {"repro_torch/data/__init__.py", "repro_torch/data/pipeline.py",
            "repro_torch/optim/__init__.py", "repro_torch/optim/adamw.py",
            "repro_torch/optim/compression.py",
            "repro_torch/checkpoint/__init__.py",
            "repro_torch/checkpoint/checkpoint.py",
            "repro_torch/launch/train.py",
            "repro_torch/training.py"} <= SRC_NAMES


def test_core_rest_sharding_and_rwkv_modules_are_scanned():
    """The modules that hold the rest of ``core/`` (calibration, the
    carbon, power and SLO helpers, the softmax peak, the batched solves),
    the sharded rollout and the RWKV6 family are among the scanned
    sources."""
    assert {"repro_torch/core/forecast.py", "repro_torch/core/carbon.py",
            "repro_torch/core/power.py", "repro_torch/core/slo.py",
            "repro_torch/core/solver.py", "repro_torch/core/spatial.py",
            "repro_torch/core/vcc.py", "repro_torch/sim/engine.py",
            "repro_torch/models/layers.py", "repro_torch/models/ssm.py",
            "repro_torch/models/transformer.py",
            "repro_torch/models/model.py"} <= SRC_NAMES


@pytest.mark.parametrize("module,source", (
    ("flash_attention", "flash_attention.cu"),
    ("flash_attention", "flash_prefill.cu"),
    ("flash_attention", "flash_decode.cu"),
    ("linear_scan", "gla_scan.cu"),
    ("linear_scan", "gla_ssd.cu")))
def test_slice_kernel_sources_are_in_the_package(module, source):
    """Kernels #4 (three sources, a route each) and #5 (two) are built from
    sources of the package, each with its plain C entry point."""
    import importlib
    kernel = importlib.import_module(f"repro_torch.kernels.{module}.kernel")
    sources = list(kernel.SOURCES.values())
    assert source in {p.name for p in sources}
    assert all(p.is_file() and p.parent == kernel.CSRC for p in sources)
    assert all(h.is_file() for h in getattr(kernel, "HEADERS", ()))
    assert kernel.CSRC == ROOT / "src" / "repro_torch" / "kernels" / \
        module / "csrc"
    for src in sources:
        assert f'extern "C" int {kernel._ENTRY[src.stem][0]}(' in \
            src.read_text()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    example = path in EXAMPLES
    bad = [m for m in imported_modules(path) if _forbidden(m, example)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_examples_are_scanned():
    """The five examples' counterparts are among the scanned sources, and
    ``benchmarks`` is forbidden in them."""
    assert {p.name for p in EXAMPLES} >= {
        "quickstart.py", "fleet_week.py", "scenario_sweep.py",
        "serve_shaped.py", "train_carbon_aware.py"}
    assert _forbidden("benchmarks.fleet_bench", example=True)
    assert not _forbidden("benchmarks.fleet_bench")


def test_checker_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.core import vcc\n"
           "from repro_torch.core import vcc as ok\nimport repro\n")
    mods = [m for node in ast.walk(ast.parse(src))
            for m in ([a.name for a in node.names]
                      if isinstance(node, ast.Import)
                      else [node.module] if isinstance(node, ast.ImportFrom)
                      else [])]
    assert [m for m in mods if _forbidden(m)] == ["jax.numpy", "repro.core",
                                                  "repro"]
