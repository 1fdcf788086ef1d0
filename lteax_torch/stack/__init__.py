"""Host-side control-plane codecs (MIB, bands)."""
