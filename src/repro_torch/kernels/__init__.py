"""Hand-written Hopper kernels of the port, each beside its plain version.

``ops`` holds the public wrappers; ``csrc/`` the CUDA sources, built by
``_build`` at first use.  Importing this package builds nothing.
"""
