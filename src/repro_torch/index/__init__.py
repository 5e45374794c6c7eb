"""The IVF index and the kNN graph."""
