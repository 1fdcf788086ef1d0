"""Physical channel codecs (PDSCH)."""
