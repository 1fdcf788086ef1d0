"""IQ sample stream I/O."""
