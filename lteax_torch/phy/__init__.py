"""PDSCH receive chain in torch, plus the numpy plan code it needs."""
