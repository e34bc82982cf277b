"""Core runtime: places, scope, op registry, block interpreter."""
