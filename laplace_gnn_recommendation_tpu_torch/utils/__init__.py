"""Host-side utilities: set ops, profiling, batch plots."""
