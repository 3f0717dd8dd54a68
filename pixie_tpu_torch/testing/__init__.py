"""Seeded inputs for the port's own checks (chip_smoke.py and the tests);
nothing of the engine imports this package."""
