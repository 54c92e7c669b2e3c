"""Attention kernels (CUDA, with plain PyTorch versions) and embeddings."""
