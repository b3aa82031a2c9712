"""Patch-based whole-cloud inference."""
