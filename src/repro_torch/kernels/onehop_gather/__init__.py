"""One-hop CSR gather + predicate filter."""
