"""Plain references, one a kind of configuration."""
