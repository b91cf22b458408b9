"""Datasets over dumped features."""
