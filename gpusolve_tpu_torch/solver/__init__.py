"""Multigrid solve loops."""
