"""PyTorch/CUDA port of the modal_examples_tpu serving and LoRA fine-tuning
paths.

Same subpackage layout as the JAX package (``ops/``, ``models/``,
``serving/``, ``training/``, ``utils/``, ``scheduling/``); each module names
its counterpart. Serving: ``LLMEngine`` and ``OpenAIServer``; training:
``training.Trainer`` over ``models.llama.forward`` with ``models.lora``
adapters.
The port imports torch and nothing of JAX or of the JAX package. Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from .serving.engine import LLMEngine
from .serving.openai_api import OpenAIServer
from .serving.sampling import SamplingParams

__all__ = ["LLMEngine", "OpenAIServer", "SamplingParams"]
