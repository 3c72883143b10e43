"""Decode heads: LinearHead, VFMHead with its transformer decoder,
Mask2Former, SegFormer, AttentionHead, DAFormer and DINOhead."""
