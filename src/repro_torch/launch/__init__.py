"""Serving: the pipeline, the checkpoint loader and the flat-index CLI."""
