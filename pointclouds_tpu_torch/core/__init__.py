"""core modules of the PyTorch port."""
