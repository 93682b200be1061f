"""Partition rules and activation-sharding hints, fault tolerance, and the
data-parallel gradient sync for the port's trainer."""
