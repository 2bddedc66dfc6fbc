"""Config parsing and device helpers."""
