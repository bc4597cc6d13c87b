"""Weight bridge and device helpers."""
