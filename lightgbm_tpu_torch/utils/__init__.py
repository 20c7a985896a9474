"""Logging of the port."""
