"""Bounded last-mile lower-bound search."""
