"""Command-line entry points (upsample)."""
