"""EmbeddingBag: gather K table rows per bag, then a masked sum or mean."""
