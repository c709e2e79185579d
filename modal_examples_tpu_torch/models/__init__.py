"""Llama model and LoRA adapters of the port."""
