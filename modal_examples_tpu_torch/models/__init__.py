"""Llama model of the port."""
