"""scene/ of the PyTorch port."""
