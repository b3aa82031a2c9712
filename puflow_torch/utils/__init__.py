"""Shared utilities: point-cloud IO, device selection."""
