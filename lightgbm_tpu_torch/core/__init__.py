"""Binning, metadata and the dataset of the port."""
