"""Read-path hash probe of the one-hop result cache."""
