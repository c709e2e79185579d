"""PyTorch/CUDA port of modal_examples_tpu: the serverless surface, the
serving engines and LoRA fine-tuning, on NVIDIA GPUs.

Same subpackage layout as the JAX package (``core/``, ``web/``,
``storage/``, ``faults/``, ``ops/``, ``models/``, ``serving/``,
``training/``, ``utils/``, ``scheduling/``, ``observability/``); each module
names its counterpart. The platform layer (``App``, ``Function``, ``Cls``,
containers, images, volumes, secrets, the CLI ``python -m
modal_examples_tpu_torch run|deploy|serve``) takes ``gpu="H100"`` where the
JAX package takes ``tpu=``, and imports no torch until a container checks
its cards or user code asks for it. Serving: ``LLMEngine`` and
``OpenAIServer``; training: ``training.Trainer`` over
``models.llama.forward`` with ``models.lora`` adapters.

The port imports torch and nothing of JAX or of the JAX package. Entry
points run on the card unless the caller passes ``device="cpu"``.

    import modal_examples_tpu_torch as mtpu

    app = mtpu.App("example")

    @app.cls(gpu="H100")
    class Model:
        @mtpu.enter()
        def load(self): ...
        @mtpu.method()
        def generate(self, prompt): ...
"""

from .core.app import App
from .core.cls import Cls, enter, exit, method, parameter
from .core.executor import FunctionTimeoutError, InputCancelled, current_input_id
from .core.function import (
    Function,
    FunctionCall,
    batched,
    concurrent,
    gather,
)
from .core.image import Image
from .core.resources import GPUSpec, parse_gpu_spec
from .core.retries import Retries
from .core.schedules import Cron, Period
from .core.serialization import RemoteError
from .storage.secret import Secret
from .storage.volume import Volume
from .web.endpoints import (
    asgi_app,
    fastapi_endpoint,
    web_endpoint,
    web_server,
    websocket_endpoint,
    wsgi_app,
)

__version__ = "0.1.0"

#: the serving entry points, imported (with torch) at first use
_SERVING = {
    "LLMEngine": ".serving.engine",
    "OpenAIServer": ".serving.openai_api",
    "SamplingParams": ".serving.sampling",
}


def __getattr__(name: str):
    if name in _SERVING:
        import importlib

        value = getattr(importlib.import_module(_SERVING[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "App",
    "Cls",
    "Cron",
    "Function",
    "FunctionCall",
    "FunctionTimeoutError",
    "GPUSpec",
    "Image",
    "InputCancelled",
    "LLMEngine",
    "OpenAIServer",
    "Period",
    "RemoteError",
    "Retries",
    "SamplingParams",
    "Secret",
    "Volume",
    "asgi_app",
    "batched",
    "concurrent",
    "current_input_id",
    "enter",
    "exit",
    "fastapi_endpoint",
    "gather",
    "method",
    "parameter",
    "parse_gpu_spec",
    "web_endpoint",
    "web_server",
    "websocket_endpoint",
    "wsgi_app",
]


class _Functions:
    """Compat namespace: ``modal.functions.gather`` spelling."""

    gather = gather
    FunctionCall = FunctionCall


functions = _Functions()
