"""Analytic, hardware-free bytes models of the MapReduce flows."""
