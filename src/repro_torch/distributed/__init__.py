"""Sharding of the port's work over devices (the population axis)."""
