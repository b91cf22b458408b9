"""Utilities: params, IO, checkpoints codec, inference API."""
