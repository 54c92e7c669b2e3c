"""Port modules: transformer blocks, DINOv2 and the motion model."""
