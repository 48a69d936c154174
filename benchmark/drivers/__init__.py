"""Drivers of the system under test, one module a driver, found by name."""
