"""Scene containers, camera and I/O (PyTorch port)."""
