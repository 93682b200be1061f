"""Fault tolerance and gradient compression for the port's trainer."""
