"""Cross-cutting utilities: metrics, checkpoints, tracing."""
