"""Observability the solve uses: span tracing on an injectable clock."""
