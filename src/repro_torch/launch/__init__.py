"""Launch layer: the store-backed compressed serving path."""
