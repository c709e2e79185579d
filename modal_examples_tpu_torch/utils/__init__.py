"""Host-side utilities: device resolution, tokenizers."""
