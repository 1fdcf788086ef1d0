"""Benchmarks of the port's paths."""
