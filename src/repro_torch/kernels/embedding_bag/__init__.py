"""EmbeddingBag: gather K table rows per bag, then a masked sum or mean;
and its table gradient, summed over each row's entries."""
