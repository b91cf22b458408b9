"""Datasets over dumped features, the batch collater and the loader."""
