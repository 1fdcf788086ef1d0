"""Test-signal generators (numpy / torch, no jax)."""
