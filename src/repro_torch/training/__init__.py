"""Training for the dense family: losses, AdamW, gradient accumulation
through the derived combiner, and the train step."""
