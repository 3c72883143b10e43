"""Decode heads: LinearHead and VFMHead with its transformer decoder."""
