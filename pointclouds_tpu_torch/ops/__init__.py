"""ops modules of the PyTorch port."""
