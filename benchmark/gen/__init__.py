"""Traffic generators, one module a generator, found by name."""
