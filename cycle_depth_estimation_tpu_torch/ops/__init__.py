"""Layers, initialisation, the int8 conv and the hand-written kernels."""
