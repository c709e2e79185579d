"""Host-side utilities: device resolution, tokenizers, nested-container (pytree) helpers, run logging."""
