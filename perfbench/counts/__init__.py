"""Kernel and stage counts, one file each (lib/counts.py finds them)."""
