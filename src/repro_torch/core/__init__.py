"""Simulation core of the port: configuration, traces, engines, oracles."""
