"""Container writers (streaming execution is ported later)."""
