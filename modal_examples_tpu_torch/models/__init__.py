"""Models of the port: Llama (with LoRA adapters, int8 and int4 weights and
Mixtral's mixture of experts, ``moe``), for the other inference workloads
bert (embeddings), whisper (transcription), clip_text, vae and diffusion
(text-to-image: the DiT and the SD3-family MMDiT), and vlm (a ViT tower in
front of Llama), gpt, vision (the detector), ocr, segmentation (SAM-style)
and video (the space-time DiT)."""
