"""GPU resource specs: the port's ``gpu=`` in place of the JAX package's
``tpu=`` (``modal_examples_tpu/core/resources.py``).

The reference requests accelerators with typed strings and fallback lists:
``gpu="H200:8"`` (vllm_inference.py:133), ``gpu=["h100", "a100", "any"]``
(gpu_fallbacks.py:20-23). A spec is a card kind and a count: ``"H100"`` (one
card), ``"h100"``, ``"H100:2"``, ``"any"`` (one card of any kind). A list is
an ordered preference: a container takes the first spec its host satisfies.

The port knows the cards whose peaks it has, the keys of
``observability/usage.py``'s ``GPU_PEAKS`` (one so far, ``"NVIDIA H100 80GB
HBM3"``): a kind is the word after "NVIDIA" in such a name, and a spec's
memory and peak rates are read from that one table. Pure parsing: no torch
import, so the client side stays light; the container checks its cards at
boot (``core/executor.py``).
"""

from __future__ import annotations

import dataclasses
import re

from ..observability.usage import GPU_PEAKS

#: the env var carrying a function's ``gpu=`` request into its container
GPU_SPEC_ENV = "MTPU_GPU_SPEC"

#: card kind -> the device name ``torch.cuda.get_device_name()`` reports
GPU_KINDS: dict[str, str] = {name.split()[1].upper(): name for name in GPU_PEAKS}

#: the kind that matches any card
ANY = "ANY"

_SPEC_RE = re.compile(r"^(?P<kind>[A-Za-z0-9]+)(?::(?P<count>\d+))?$")


class InvalidGPUSpec(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """A parsed card request: ``gpu="H100:2"`` -> kind H100, 2 cards."""

    kind: str
    count: int = 1

    @property
    def device_name(self) -> str | None:
        """The card's name as torch reports it; None for ``any``."""
        return GPU_KINDS.get(self.kind)

    @property
    def memory_gb(self) -> int | None:
        """Device memory of one card, from its name (``... 80GB ...``)."""
        m = re.search(r"(\d+)GB", self.device_name or "")
        return int(m.group(1)) if m else None

    @property
    def bf16_tflops_per_card(self) -> float | None:
        return GPU_PEAKS[self.device_name][0] if self.device_name else None

    @property
    def hbm_gbps_per_card(self) -> float | None:
        return GPU_PEAKS[self.device_name][1] if self.device_name else None

    def matches(self, device_name: str) -> bool:
        """Whether a card of this name is of this spec's kind."""
        return self.kind == ANY or self.kind in device_name.upper().split()

    def __str__(self) -> str:
        return f"{self.kind}:{self.count}"


def parse_gpu_spec(spec: str) -> GPUSpec:
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise InvalidGPUSpec(
            f"invalid gpu spec {spec!r}; expected e.g. 'H100', 'H100:2', 'any'"
        )
    kind = m.group("kind").upper()
    if kind != ANY and kind not in GPU_KINDS:
        raise InvalidGPUSpec(
            f"unknown GPU kind {m.group('kind')!r}; known: {sorted(GPU_KINDS)} or 'any'"
        )
    count = int(m.group("count") or 1)
    if count < 1:
        raise InvalidGPUSpec("card count must be >= 1")
    return GPUSpec(kind=kind, count=count)


def parse_gpu_request(
    gpu: str | list[str] | tuple[str, ...] | None,
) -> list[GPUSpec]:
    """Parse a ``gpu=`` argument into an ordered preference list
    (gpu_fallbacks.py:20-23): a container takes the first spec its host
    satisfies."""
    if gpu is None:
        return []
    if isinstance(gpu, str):
        return [parse_gpu_spec(gpu)]
    specs = [parse_gpu_spec(s) for s in gpu]
    if not specs:
        raise InvalidGPUSpec("empty gpu fallback list")
    return specs


def format_gpu_request(specs: list[GPUSpec]) -> str:
    """The ``MTPU_GPU_SPEC`` value a container gets: the preference list,
    comma-separated (``"H100:1,ANY:1"``)."""
    return ",".join(str(s) for s in specs)


def select_gpu_spec(request: str, device_names: list[str]) -> GPUSpec:
    """The first spec of ``request`` (an ``MTPU_GPU_SPEC`` value) that the
    visible cards satisfy: at least ``count`` cards, the first ``count`` of
    its kind. Raises ``RuntimeError`` naming the request and the cards
    otherwise."""
    for spec in parse_gpu_request(request.split(",")):
        chosen = device_names[: spec.count]
        if len(chosen) == spec.count and all(spec.matches(n) for n in chosen):
            return spec
    raise RuntimeError(
        f"gpu={request!r}: this container sees {len(device_names)} card(s) "
        f"{device_names}, which satisfy no spec of the request"
    )
