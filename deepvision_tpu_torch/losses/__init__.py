"""Losses and metrics of the port."""
