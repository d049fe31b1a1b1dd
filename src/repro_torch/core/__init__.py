"""Skip-LoRA adapters, the adapter pool and the generation entry points."""
