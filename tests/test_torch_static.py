"""Static guards on the PyTorch/CUDA port (AST only, nothing imported):

- no module of the port, nor ``chip_smoke.py``, imports JAX or the JAX package;
- every ``csrc/*.cu`` kernel has a launching wrapper (``*_cuda``) that counts
  its launches in a module-level integer, and a plain twin (``*_plain``);
- no ``try`` surrounds a kernel launch, so a CUDA tensor never falls back to
  the plain version.
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
    assert KERNELS == ["flash_bwd_dkv", "flash_bwd_dq", "flash_fwd", "kv_scatter", "paged_decode"]


def test_import_scan_reaches_the_training_path():
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    for mod in ("training/trainer.py", "training/checkpoints.py", "training/resilience.py",
                "models/lora.py", "utils/tracking.py", "utils/tree.py"):
        assert mod in names


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
