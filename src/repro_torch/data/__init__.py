"""Data pipeline (a copy of the reference's numpy-only module)."""
