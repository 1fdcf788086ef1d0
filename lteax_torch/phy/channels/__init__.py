"""Physical channel codecs (PDSCH, PBCH)."""
