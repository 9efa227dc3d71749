"""Host-side utilities of the PyTorch package (stage timing)."""
