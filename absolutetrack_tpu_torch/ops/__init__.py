"""Ops: crop warp (K1 and its plain version), Procrustes."""
