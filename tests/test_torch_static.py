"""Static guards on the PyTorch/CUDA port (AST only, nothing imported):

- no module of the port, nor ``chip_smoke.py``, imports JAX or the JAX package;
- every ``csrc/*.cu`` kernel has a launching wrapper (``*_cuda``) that counts
  its launches in a module-level integer, and a plain twin (``*_plain``);
- no ``try`` surrounds a kernel launch, so a CUDA tensor never falls back to
  the plain version;
- the speculation modules are scanned, and nothing in the port imports the
  single-sequence oracle ``serving/speculative.py`` (the JAX package's
  quarantine of its oracle): only tests do.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "modal_examples_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
KERNELS = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _imported_modules(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(_tree(path)):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "modal_examples_tpu"), f"{path.name} imports {mod}"


def _ops_functions():
    for path in sorted((PKG / "ops").glob("*.py")):
        tree = _tree(path)
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                yield path, tree, node


def _launches(fn: ast.FunctionDef, kernel: str) -> bool:
    return any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == kernel
        for n in ast.walk(fn)
    )


def test_there_are_kernels():
    assert KERNELS == [
        "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd", "kv_scatter", "kv_scatter_int8", "paged_decode",
        "paged_decode_int8", "paged_decode_writeback", "paged_decode_writeback_int8", "quantized_matmul",
    ]


def test_import_scan_reaches_the_training_path():
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    for mod in ("training/trainer.py", "training/checkpoints.py", "training/resilience.py",
                "models/lora.py", "utils/tracking.py", "utils/tree.py"):
        assert mod in names


def test_import_scan_reaches_the_macro_step_path():
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    for mod in ("ops/scan_loop.py", "serving/multistep/__init__.py", "serving/multistep/runtime.py",
                "serving/multistep/detok.py"):
        assert mod in names


def test_import_scan_reaches_the_speculation_path():
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    for mod in ("serving/spec_runtime/__init__.py", "serving/spec_runtime/runtime.py",
                "serving/spec_runtime/controller.py", "serving/speculative.py"):
        assert mod in names


def test_import_scan_reaches_the_inference_workloads():
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    for mod in ("models/bert.py", "models/whisper.py", "models/clip_text.py", "models/vae.py",
                "models/diffusion.py", "serving/streaming_asr.py", "utils/audio.py", "utils/metrics.py",
                "utils/images.py"):
        assert mod in names


def test_import_scan_reaches_the_platform_layer():
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    for mod in ("__main__.py", "core/app.py", "core/cls.py", "core/function.py", "core/executor.py",
                "core/container_worker.py", "core/serialization.py", "core/resources.py", "core/image.py",
                "core/cli.py", "web/gateway.py", "web/server.py", "storage/volume.py", "storage/secret.py",
                "faults/inject.py", "utils/log.py"):
        assert mod in names


def _imports_of(path: Path):
    """(module, names) of every import in ``path``, relative ones resolved
    against its package."""
    pkg = path.relative_to(ROOT).with_suffix("").parts[:-1]
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            yield from ((a.name, ()) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = list(pkg[: len(pkg) - node.level + 1]) if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod, tuple(a.name for a in node.names)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_in_the_port_imports_the_speculative_oracle(path):
    oracle = "modal_examples_tpu_torch.serving.speculative"
    for mod, names in _imports_of(path):
        assert mod != oracle and not mod.startswith(oracle + "."), f"{path.name} imports the oracle"
        if mod == "modal_examples_tpu_torch.serving":
            assert "speculative" not in names, f"{path.name} imports the oracle"


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_has_counted_wrapper_and_plain_twin(kernel):
    launchers = [(p, t, f) for p, t, f in _ops_functions() if _launches(f, kernel)]
    assert len(launchers) == 1, f"{kernel}: want exactly one launching wrapper, got {len(launchers)}"
    path, tree, fn = launchers[0]
    assert fn.name.endswith("_cuda"), f"{kernel}: wrapper {fn.name} should be named *_cuda"
    counters = {n for g in ast.walk(fn) if isinstance(g, ast.Global) for n in g.names}
    bumps = [
        n for n in ast.walk(fn)
        if isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Name)
        and n.target.id in counters and isinstance(n.value, ast.Constant) and n.value.value == 1
    ]
    assert len(bumps) == 1, f"{fn.name} must add one to a module-level counter per launch"
    module_ints = {
        t.id for n in tree.body if isinstance(n, ast.Assign)
        and isinstance(n.value, ast.Constant) and n.value.value == 0
        for t in n.targets if isinstance(t, ast.Name)
    }
    assert bumps[0].target.id in module_ints
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert fn.name[: -len("_cuda")] + "_plain" in names, f"{fn.name} has no plain twin"


def test_no_try_around_a_launch():
    launchers = {f.name for _, _, f in _ops_functions() if any(_launches(f, k) for k in KERNELS)}
    for path in PORT_FILES:
        for node in ast.walk(_tree(path)):
            if isinstance(node, ast.FunctionDef) and node.name in launchers:
                assert not any(isinstance(n, ast.Try) for n in ast.walk(node)), f"try inside {node.name}"
            if isinstance(node, ast.Try):
                called = {
                    n.func.attr if isinstance(n.func, ast.Attribute) else getattr(n.func, "id", None)
                    for n in ast.walk(node) if isinstance(n, ast.Call)
                }
                assert not called & (launchers | set(KERNELS)), f"{path.name}: try around a kernel launch"
