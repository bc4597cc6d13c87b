"""Decode, box geometry and postprocessing on tensors."""
