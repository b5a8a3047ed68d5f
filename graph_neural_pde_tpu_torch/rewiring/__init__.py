"""Load-time graph rewiring (PyTorch port of ``rewiring/``)."""
