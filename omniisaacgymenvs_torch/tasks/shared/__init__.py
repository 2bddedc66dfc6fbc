"""Shared task logic."""
