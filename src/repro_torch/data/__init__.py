"""Synthetic data pipeline (numpy only)."""
