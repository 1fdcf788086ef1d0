"""3GPP TS 36.211/36.212/36.213 constant tables."""
