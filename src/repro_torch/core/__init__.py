"""Skip-LoRA adapters and training steps, the Skip-Cache, the adapter pool
and the generation entry points."""
