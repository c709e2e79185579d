"""Attention, paged-cache and int8 matmul ops of the PyTorch/CUDA port:
hand-written CUDA kernels for the card (built from ``../csrc`` at first use),
each with its plain PyTorch version for CPU tensors. Import the modules
themselves (``ops.flash_attention``, ``ops.paged_attention``,
``ops.quantized_matmul``): their launch counters are module attributes."""
