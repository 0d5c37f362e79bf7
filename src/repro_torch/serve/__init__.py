"""Serving: the end-to-end ServingEngine."""
