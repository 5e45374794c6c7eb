"""k-means and product quantization."""
