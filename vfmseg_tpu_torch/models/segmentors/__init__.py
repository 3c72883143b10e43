"""Segmentors: MsVFM inference methods."""
