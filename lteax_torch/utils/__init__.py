"""Cross-cutting utilities: metrics, checkpoints."""
