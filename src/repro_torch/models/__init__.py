"""Model definitions (the paper's CNN)."""
