"""Shared utilities: metrics, logging, config."""
