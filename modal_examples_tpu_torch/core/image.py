"""Layered container image DSL, after ``modal_examples_tpu/core/image.py``,
for the CUDA port.

Reference spec: the chainable image API
``modal.Image.debian_slim().uv_pip_install(...).apt_install(...).env(...)``
(text_embeddings_inference.py:63-71, vllm_inference.py:35-45), registry bases
via ``from_registry(..., add_python=...)`` (install_cuda.py:40),
``run_function`` build steps, ``add_local_dir/file``
(simple_torch_cluster.py:35-38), and the ``image.imports()`` context manager
(import_sklearn.py:25-27).

Design: an :class:`Image` is an immutable chain of content-addressed layers.
The local backend doesn't build OCI images; it *applies* the layers it can
(env vars, run_function build steps — cached by layer hash in the state dir,
the analog of Modal's image build cache) and records the rest (apt/pip) as the
build recipe a real image build would execute. The CUDA base,
:meth:`Image.cuda_base`, declares Python, torch and the CUDA toolkit, with no
jax: it stands where the JAX package's ``tpu_base`` stands. Every other layer
and the digest are the JAX package's, so one chain gives one digest in both
packages once the base layer is left out. :meth:`Image.export_oci` writes an
OCI image layout (``core/oci.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Callable, Sequence

from .._internal import config as _config


@dataclasses.dataclass(frozen=True)
class ImageLayer:
    kind: str  # base | pip | apt | env | run_commands | run_function | workdir | entrypoint | add_local
    payload: tuple  # hashable description
    # run_function layers carry the callable out-of-band (not hashed by code id)
    fn: Callable | None = dataclasses.field(default=None, compare=False)

    def digest_item(self) -> str:
        return json.dumps([self.kind, list(map(str, self.payload))])


class Image:
    """Immutable chainable image definition."""

    def __init__(self, layers: tuple[ImageLayer, ...] = ()):
        self._layers = layers

    # -- constructors -------------------------------------------------------

    @staticmethod
    def debian_slim(python_version: str | None = None) -> "Image":
        return Image((ImageLayer("base", ("debian_slim", python_version or "")),))

    @staticmethod
    def cuda_base(python_version: str | None = None) -> "Image":
        """Base layer: Python, torch built for CUDA, and the CUDA toolkit
        (``nvcc`` builds the port's kernels at first use). No jax."""
        img = Image((ImageLayer("base", ("cuda_base", python_version or "")),))
        return img.uv_pip_install("torch", "numpy").apt_install("cuda-toolkit")

    @staticmethod
    def from_registry(tag: str, add_python: str | None = None) -> "Image":
        return Image((ImageLayer("base", ("registry", tag, add_python or "")),))

    @staticmethod
    def micromamba(python_version: str | None = None) -> "Image":
        return Image((ImageLayer("base", ("micromamba", python_version or "")),))

    # -- chainable layers ---------------------------------------------------

    def _add(self, layer: ImageLayer) -> "Image":
        return Image(self._layers + (layer,))

    def pip_install(self, *packages: str, **kw) -> "Image":
        return self._add(ImageLayer("pip", tuple(sorted(packages))))

    def uv_pip_install(self, *packages: str, **kw) -> "Image":
        return self._add(ImageLayer("pip", tuple(sorted(packages))))

    def micromamba_install(self, *packages: str, channels: Sequence[str] = (), **kw) -> "Image":
        return self._add(ImageLayer("pip", tuple(sorted(packages)) + tuple(channels)))

    def apt_install(self, *packages: str) -> "Image":
        return self._add(ImageLayer("apt", tuple(sorted(packages))))

    def env(self, vars: dict[str, str]) -> "Image":
        return self._add(ImageLayer("env", tuple(sorted(vars.items()))))

    def workdir(self, path: str) -> "Image":
        return self._add(ImageLayer("workdir", (path,)))

    def entrypoint(self, cmd: Sequence[str]) -> "Image":
        return self._add(ImageLayer("entrypoint", tuple(cmd)))

    def run_commands(self, *commands: str) -> "Image":
        return self._add(ImageLayer("run_commands", tuple(commands)))

    def run_function(self, fn: Callable, **kw) -> "Image":
        """Run ``fn`` once at build time (e.g. weight pre-download); cached."""
        name = getattr(fn, "__qualname__", repr(fn))
        return self._add(ImageLayer("run_function", (name,), fn=fn))

    def add_local_dir(self, local_path: str, remote_path: str, copy: bool = False) -> "Image":
        return self._add(ImageLayer("add_local", ("dir", local_path, remote_path)))

    def add_local_file(self, local_path: str, remote_path: str, copy: bool = False) -> "Image":
        return self._add(ImageLayer("add_local", ("file", local_path, remote_path)))

    def add_local_python_source(self, *modules: str) -> "Image":
        return self._add(ImageLayer("add_local", ("pysource",) + tuple(modules)))

    # -- introspection / application ---------------------------------------

    def export_oci(self, dest: str, *, tag: str = "latest") -> dict:
        """Serialize as a spec-valid OCI image layout at ``dest`` (local
        content becomes real layer blobs; network steps become provenance
        history). See :mod:`modal_examples_tpu_torch.core.oci`."""
        from .oci import export_oci

        return export_oci(self, dest, tag=tag)

    @property
    def layers(self) -> tuple[ImageLayer, ...]:
        return self._layers

    def digest(self) -> str:
        h = hashlib.sha256()
        for layer in self._layers:
            h.update(layer.digest_item().encode())
        return h.hexdigest()[:16]

    def env_vars(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for layer in self._layers:
            if layer.kind == "env":
                out.update(dict(layer.payload))
        return out

    def python_packages(self) -> list[str]:
        out: list[str] = []
        for layer in self._layers:
            if layer.kind == "pip":
                out.extend(layer.payload)
        return out

    def sys_path_additions(self) -> list[str]:
        """Local dirs that must be importable inside the container."""
        out = []
        for layer in self._layers:
            if layer.kind == "add_local" and layer.payload[0] == "dir":
                out.append(layer.payload[1])
        return out

    @contextlib.contextmanager
    def imports(self):
        """Import block tolerant of locally-missing container-only packages.

        Reference: ``with image.imports(): import sklearn``
        (02_building_containers/import_sklearn.py:25-27) — inside a container
        the import must succeed; on the client it is silently skipped.
        """
        try:
            yield
        except ImportError:
            if _config.in_container():
                raise

    def build_local(self) -> dict[str, str]:
        """Apply this image for a local-backend container; returns env vars.

        run_function build steps execute once and are cached by layer-chain
        digest (the build-cache analog). pip/apt layers are validated against
        the current interpreter where possible but not installed (the
        environment is pre-baked: nothing installs over the network).
        """
        marker_dir = _config.state_dir() / "image_builds"
        marker_dir.mkdir(parents=True, exist_ok=True)
        env = self.env_vars()
        running_digest = hashlib.sha256()
        for layer in self._layers:
            running_digest.update(layer.digest_item().encode())
            if layer.kind == "run_function" and layer.fn is not None:
                marker = marker_dir / (running_digest.hexdigest()[:16] + ".done")
                if not marker.exists():
                    old_env = dict(os.environ)
                    os.environ.update(env)
                    try:
                        layer.fn()
                    finally:
                        os.environ.clear()
                        os.environ.update(old_env)
                    marker.write_text("ok")
        return env


#: Default image used when a Function doesn't specify one.
DEFAULT_IMAGE = Image.debian_slim()
