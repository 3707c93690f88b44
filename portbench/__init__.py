"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell a run,
driven by the data files under this folder (see ``run.py``)."""
