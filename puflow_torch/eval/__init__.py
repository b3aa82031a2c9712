"""Evaluation metrics and the tools behind `evaluation.csv`."""
