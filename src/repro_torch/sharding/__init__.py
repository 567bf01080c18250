"""Sharding rules (`rules.py`)."""
