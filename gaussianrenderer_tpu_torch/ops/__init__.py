"""Per-frame render stages (PyTorch port)."""
