"""Model configs and the backbone: layers, attention, blocks, LM."""
