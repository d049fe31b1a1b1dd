"""Grouped Skip-LoRA skip-sum: plain versions, Hopper kernels, wrappers."""
