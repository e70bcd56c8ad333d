"""Plain PyTorch references for the CPU tests: each imports torch only."""
