"""Data-parallel training across processes (counterpart of parallel/)."""
