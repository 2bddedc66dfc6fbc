"""Articulation physics of the PyTorch port."""
