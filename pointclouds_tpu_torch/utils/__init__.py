"""utils modules of the PyTorch port."""
