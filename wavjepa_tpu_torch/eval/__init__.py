"""HEAR evaluation harness of the PyTorch port."""
