"""Checksummed, atomic checkpoints in the reference's on-disk format
(``ckpt.py``)."""
