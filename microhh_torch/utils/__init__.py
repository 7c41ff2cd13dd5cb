"""Host-side utilities of the PyTorch port."""
