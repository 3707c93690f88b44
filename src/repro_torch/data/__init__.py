"""Synthetic datasets (numpy), shared bit for bit with the reference."""
