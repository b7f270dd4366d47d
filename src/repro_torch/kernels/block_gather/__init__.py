"""Owner-local block gather + predicate filter of the partitioned tier."""
