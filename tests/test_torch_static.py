"""Static guards on the PyTorch/CUDA port (AST only, nothing imported):

- no module of the port, nor ``chip_smoke.py``, imports JAX or the JAX package;
- every ``csrc/*.cu`` kernel has a launching wrapper (``*_cuda``) that counts
  its launches in a module-level integer, and a plain twin (``*_plain``);
- no ``try`` surrounds a kernel launch, so a CUDA tensor never falls back to
  the plain version;
- the speculation modules are scanned, and nothing in the port imports the
  single-sequence oracle ``serving/speculative.py`` (the JAX package's
  quarantine of its oracle): only tests do;
- the drivers ``fleet/loadgen.py`` and ``faults/chaos.py`` are scanned, and
  no module of the port imports them: tests and ``chip_smoke.py`` do.
"""

import ast
from pathlib import Path

import pytest
from test_torch_time_limit import share_cores

share_cores()

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
        "quantized_matmul_int4",
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


def test_import_scan_reaches_the_platform_layers_rest():
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    for mod in ("storage/dict_queue.py", "core/sandbox.py", "web/websocket.py", "core/oci.py", "storage/gcs.py",
                "utils/docs.py", "snapshot/__init__.py", "snapshot/store.py", "snapshot/codec.py",
                "snapshot/capture.py", "snapshot/restore.py"):
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


def test_import_scan_reaches_the_fleet_layers():
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    for mod in ("serving/health.py", "serving/failover.py", "serving/disagg/__init__.py",
                "serving/disagg/transport.py", "serving/disagg/roles.py", "scheduling/router.py"):
        assert mod in names


def test_import_scan_reaches_the_prefix_tiers_fleet_and_chaos():
    names = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    for mod in ("serving/prefix_store/__init__.py", "serving/prefix_store/ownership.py",
                "serving/prefix_store/store.py", "serving/disagg/tiered_cache.py", "fleet/__init__.py",
                "fleet/autoscaler.py", "fleet/loadgen.py", "faults/chaos.py"):
        assert mod in names


DRIVERS = ("modal_examples_tpu_torch.fleet.loadgen", "modal_examples_tpu_torch.faults.chaos")


@pytest.mark.parametrize("path", [p for p in PORT_FILES if PKG in p.parents], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_of_the_port_imports_a_driver(path):
    """The load generator and the chaos runner drive the serving path from
    outside; a production import would put them on it (the JAX package's
    layering rule)."""
    for mod, names in _imports_of(path):
        for driver in DRIVERS:
            assert mod != driver and not mod.startswith(driver + "."), f"{path.name} imports {driver}"
            parent, leaf = driver.rsplit(".", 1)
            assert not (mod == parent and leaf in names), f"{path.name} imports {driver}"
