"""pipelines modules of the PyTorch port."""
