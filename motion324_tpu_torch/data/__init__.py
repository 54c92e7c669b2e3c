"""Training data: the Dyscene16k dataset and its surface-point tracking."""
