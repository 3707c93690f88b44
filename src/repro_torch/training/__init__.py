"""Training for every model family (dense, moe, vlm, ssm, hybrid, audio):
losses, AdamW, gradient accumulation through the derived combiner, and the
train step.  The step is family-generic: it reaches a model through
``forward`` and ``unembed_matrix``, and microbatches split every leaf of
the batch (whisper's ``frames`` too) along its first axis."""
