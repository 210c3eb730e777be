"""mpc/ of the PyTorch port."""
