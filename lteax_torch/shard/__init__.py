"""Channel-batched scanner front (one device; the reference's mesh
sharding is not ported)."""
