"""Architecture configs ported so far (one module per architecture)."""
