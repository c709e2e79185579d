"""Models of the port: Llama (with LoRA adapters, int8 weights and Mixtral's
mixture of experts, ``moe``), and for the other inference workloads bert
(embeddings), whisper (transcription), clip_text, vae and diffusion
(text-to-image: the DiT and the SD3-family MMDiT)."""
