"""spatial modules of the PyTorch port."""
