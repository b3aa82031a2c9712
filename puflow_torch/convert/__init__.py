"""Checkpoint conversion from the reference's torch state_dicts."""
