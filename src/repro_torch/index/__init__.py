"""The IVF index."""
