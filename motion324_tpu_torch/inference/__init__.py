"""Inference: sliding windows, smoothing and the mesh + video pipeline."""
