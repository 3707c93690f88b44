"""The port's serving loop: prefill, then batched decode."""
