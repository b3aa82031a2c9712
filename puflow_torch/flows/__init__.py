"""Invertible flow primitives as functions over parameter trees of tensors.

Every layer exposes ``*_forward(params, x, ...) -> (y, logdet)`` and
``*_inverse(params, z, ...) -> (x, logdet)``, as in `puflow_tpu.flows`.
"""
