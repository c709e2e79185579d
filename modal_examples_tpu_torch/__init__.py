"""PyTorch/CUDA port of the modal_examples_tpu serving path.

Same subpackage layout as the JAX package (``ops/``, ``models/``,
``serving/``, ``utils/``, ``scheduling/``); each module names its counterpart.
The port imports torch and nothing of JAX or of the JAX package. Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from .serving.engine import LLMEngine
from .serving.openai_api import OpenAIServer
from .serving.sampling import SamplingParams

__all__ = ["LLMEngine", "OpenAIServer", "SamplingParams"]
