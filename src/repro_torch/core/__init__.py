"""CSP layout, patched operators, cache and the serving engine."""
