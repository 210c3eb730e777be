"""physics/ of the PyTorch port."""
