"""Flash attention (K4): plain version, CUDA kernel and GQA-folding wrapper."""
