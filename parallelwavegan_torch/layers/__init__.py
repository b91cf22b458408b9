"""Layer modules, channels-last (B, T, C)."""
